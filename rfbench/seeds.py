"""Seeds of one run, derived from ``--seed`` by purpose."""

from __future__ import annotations

import hashlib


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` (weights, noise, corpus, ...): distinct
    purposes and distinct run seeds give unrelated streams."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1

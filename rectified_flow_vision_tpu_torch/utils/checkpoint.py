"""Checkpoint I/O for param trees, in the JAX package's ``.npz`` format.

A model checkpoint is one ``.npz`` file holding the flattened HWIO/(in, out)
param tree (``/``-joined keys, e.g. ``enc_blocks/0_0/conv1/w``) plus a JSON
config blob under ``__config__``. Files written by the JAX package load here
and the other way round. Reference ``.pt`` files go through
``utils.pt_import`` (dispatched on the file extension in ``load_params``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

Params = Dict[str, Any]

_SEP = "/"
_CONFIG_KEY = "__config__"


def flatten_tree(tree: Params, prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict tree into {path: leaf} with '/'-joined keys."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = tree
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Params:
    tree: Params = {}
    for path, arr in flat.items():
        keys = path.split(_SEP)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def save_params(
    path: os.PathLike | str, params: Params, config: Optional[dict] = None
) -> None:
    """Save a param tree of numpy arrays (+ JSON config) to one .npz file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    if config is not None:
        flat[_CONFIG_KEY] = np.frombuffer(
            json.dumps(config).encode("utf-8"), dtype=np.uint8
        )
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    print(f"Model saved to: {path}")


def load_params(path: os.PathLike | str) -> Tuple[Params, Optional[dict]]:
    """Load (params, config) from .npz; '.pt' files go through pt_import."""
    path = Path(path)
    if path.suffix == ".pt":
        from rectified_flow_vision_tpu_torch.utils.pt_import import (
            import_pt_checkpoint,
        )

        return import_pt_checkpoint(path)
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    config = None
    if _CONFIG_KEY in flat:
        config = json.loads(bytes(flat.pop(_CONFIG_KEY)).decode("utf-8"))
    return unflatten_tree(flat), config

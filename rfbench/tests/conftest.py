"""Shared pieces of the benchmark's own tests (run on the CPU; those marked
``cuda`` need a card and skip without one):

    python -m pytest rfbench/tests -q

``tiny(cell)`` is a cell of the manifest with narrow widths and light traffic,
so that the whole harness (program, window, reference, checks) runs on the
CPU in seconds; every other setting is the cell's own.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rfbench import core  # noqa: E402

CELLS = [w["name"] for w in core.manifest()["workloads"]]
SERVE = [c for c in CELLS if core.cell(c).traffic["kind"] == "serve_open_loop"]
TRAIN = [c for c in CELLS if core.cell(c).traffic["kind"] == "train_epochs"]

TINY_MODEL = {
    "unet": {"image_size": 16, "model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1},
    "dit": {"image_size": 16, "hidden_size": 64, "depth": 2, "num_heads": 2},
}
TINY_VAE = {"image_size": 64, "base_channels": 16}
TINY_TRAFFIC = {
    "serve_open_loop": {"rate_per_s": 6, "senders": 8, "sizes": {"log_uniform": [1, 8]},
                        "service_batch": 8, "check_images": 8, "check_block": 4, "trace_calls": 2},
    "train_epochs": {"batch": 8, "corpus_batches": 4, "steps_per_call": 2, "check_block": 4},
}


def tiny(name: str) -> core.Cell:
    cell = core.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(TINY_MODEL[cell.config["model"]["backbone"]])
    if cell.config.get("vae"):
        cell.config["vae"].update(TINY_VAE)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[cell.traffic["kind"]])
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    """The CUDA device, decided here and not at import; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

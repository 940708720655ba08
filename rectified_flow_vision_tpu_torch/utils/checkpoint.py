"""Checkpoint I/O for param trees, in the JAX package's ``.npz`` format.

A model checkpoint is one ``.npz`` file holding the flattened HWIO/(in, out)
param tree (``/``-joined keys, e.g. ``enc_blocks/0_0/conv1/w``) plus a JSON
config blob under ``__config__``. Files written by the JAX package load here
and the other way round. Reference ``.pt`` files go through
``utils.pt_import`` (dispatched on the file extension in ``load_params``).
``AsyncSaver`` writes such a file from a background thread.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

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


def host_snapshot(tree: Any) -> Any:
    """A copy of ``tree`` (nested dicts / lists / tuples of tensors and numpy
    arrays) on the host that no later update can reach: tensors become CPU
    tensors, numpy arrays copies.

    Torch updates parameters and optimizer state in place, so a snapshot
    must be a copy taken before the next step runs: on the CPU
    ``tensor.cpu()`` returns the live tensor itself, hence ``to("cpu",
    copy=True)``; a CUDA tensor's device-to-host copy is a blocking one,
    complete when this returns.
    """
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class AsyncSaver:
    """Background-thread checkpoint writer so training never blocks on I/O.

    ``save`` takes the host snapshot on the caller's thread (so the next
    optimizer step cannot change what is written) and hands the ``.npz``
    write (``save_params``: ``tmp`` file, then ``os.replace``) to one
    background thread. ``submit`` runs any other write function there (the
    train state's). A new write first waits for the one in flight; ``wait``
    re-raises a failed write's error on the caller's thread.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path, params, config=None) -> None:
        self.wait()
        self.submit(save_params, path, host_snapshot(params), config)

    def submit(self, write: Callable[..., Any], *args: Any) -> None:
        """Run ``write(*args)`` on the background thread; its arguments must
        be snapshots that no later update reaches."""
        self.wait()

        def run() -> None:
            try:
                write(*args)
            except BaseException as e:  # surfaced by wait() on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight is done; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

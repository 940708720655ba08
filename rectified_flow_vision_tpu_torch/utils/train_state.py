"""Mid-training resume: the full train state, saved per epoch cadence.

Counterpart of the JAX package's ``utils/train_state.py``, whose
``TrainStateManager`` keeps the state in Orbax checkpoints. Here the same
contract runs on ``torch.save`` / ``torch.load(weights_only=True)``:

* ``save(epoch, params, opt_state, losses, ema=None)`` writes the model's
  state dict, the optimizer state (``FlowOptimizer.state_dict()``: its
  ``step_count``, which the lr schedule is read from, beside AdamW's own
  state), the per-epoch losses and the EMA weights. The snapshot is taken
  on the caller's thread (torch updates all of these in place), the write
  runs on ``checkpoint.AsyncSaver``'s background thread, and each epoch's file is committed
  atomically (a ``.tmp`` file, then ``os.replace``), so a crash leaves the
  previous epochs readable;
* the newest ``max_to_keep`` epochs are kept;
* ``restore()`` returns ``(params, opt_state, losses, next_epoch,
  ema_or_None)`` of the latest committed epoch (tensors on the CPU, for
  ``load_state_dict``), or None when there is none.

The files are the port's own: the JAX package cannot read them, nor this
package its Orbax directories. A run resumes in the package that wrote it.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from rectified_flow_vision_tpu_torch.utils.checkpoint import AsyncSaver, host_snapshot

_FILE = re.compile(r"^epoch_(\d+)\.pt$")


class TrainStateManager:
    """Train-state save / restore keyed by epoch, one ``.pt`` file each."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = AsyncSaver()
        self._last_saved = self.latest_epoch()

    def _path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{epoch:08d}.pt"

    def epochs(self) -> List[int]:
        """The committed epochs, oldest first."""
        found = (_FILE.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_epoch(self) -> Optional[int]:
        done = self.epochs()
        return done[-1] if done else None

    def save(
        self, epoch: int, params, opt_state, losses: List[float], ema=None
    ) -> bool:
        """Snapshot the state now and write it in the background. An epoch at
        or below the last one saved is skipped (returns False), as Orbax's
        ``CheckpointManager.save`` skips a step it already holds."""
        if self._last_saved is not None and epoch <= self._last_saved:
            return False
        self.wait()
        state = {
            "epoch": int(epoch),
            "params": host_snapshot(dict(params)),
            "opt_state": host_snapshot(opt_state),
            "losses": torch.tensor(list(losses), dtype=torch.float64),
            "ema": host_snapshot(dict(ema)) if ema is not None else None,
        }
        self._last_saved = epoch
        self._writer.submit(self._write, epoch, state)
        return True

    def _write(self, epoch: int, state: Dict[str, Any]) -> None:
        path = self._path(epoch)
        tmp = path.with_suffix(".pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.epochs()[: -self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(
        self, map_location: str | torch.device = "cpu"
    ) -> Optional[Tuple[Dict[str, torch.Tensor], Dict[str, Any], List[float], int, Any]]:
        """(params, opt_state, losses, next_epoch, ema_or_None) from the
        latest committed epoch, or None when no state exists."""
        self.wait()
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        state = torch.load(self._path(epoch), map_location=map_location, weights_only=True)
        losses = [float(x) for x in state["losses"].reshape(-1)]
        return state["params"], state["opt_state"], losses, epoch + 1, state["ema"]

    def wait(self) -> None:
        """Block until the write in flight is committed; re-raise its error."""
        self._writer.wait()

    def close(self) -> None:
        self.wait()

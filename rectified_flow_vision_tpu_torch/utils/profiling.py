"""Profiling hook on ``torch.profiler``: ``trace(logdir)``, the port's
counterpart of the JAX package's ``utils/profiling.trace``, which
``experiments/benchmark.py`` wraps around a run when ``RFV_PROFILE`` names a
directory. It records host and device activity and writes it to
``<logdir>/trace.json`` (chrome trace format; TensorBoard and Perfetto load
it)."""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str = "logs/torch_trace") -> Iterator[None]:
    """Capture a trace of the enclosed code (the card's kernels too, when
    there is one) into ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))

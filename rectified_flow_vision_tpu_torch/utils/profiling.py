"""Profiling and debugging hooks on ``torch.profiler`` and the dispatcher.

Counterpart of the JAX package's ``utils/profiling.py``:

* ``trace(logdir)``: records host and device activity of the enclosed code
  into ``<logdir>/trace.json`` (chrome trace format; TensorBoard and
  Perfetto load it). ``experiments/benchmark.py`` wraps a run in it when
  ``RFV_PROFILE`` names a directory;
* ``annotate(name)``: a named span (``torch.profiler.record_function``) that
  appears under that name in the trace. While no profiler records, it is a
  shared no-op context: the check costs well under a microsecond, where an
  idle ``record_function`` costs about 10 us on the host, so the spans stay
  on the hot paths. The port's spans, all named ``rfv.*``:

  - ``rfv.batcher.call``: ``serving_http.Batcher``, one group's call, its
    slicing and its wake-ups;
  - ``rfv.generate``: ``serving.SamplerService.generate``, the whole call;
    inside it ``rfv.generate.noise`` (a batch's noise draw), ``rfv.decode``
    (the ConvVAE decode of a latent service), ``rfv.generate.device_wait``
    (the stream synchronise after the clamp) and ``rfv.generate.to_host``
    (the copy of the images to the host);
  - ``rfv.sampler.step``: ``models.base_flow`` ``_get_sampler``, one ODE
    step as the host issues it;
  - ``rfv.train.gather``: ``make_train_epoch``, a step's batch gather;
  - ``rfv.train.step``: ``make_train_step``, one step, holding
    ``rfv.train.loss``, ``.backward``, ``.optimizer`` and ``.ema``;
* ``nan_check(enable)``: raises ``FloatingPointError`` where an op produces
  a NaN, as ``jax_debug_nans`` does; restores the previous state on exit;
* ``device_memory_stats()``: bytes in use and their peak per CUDA device.
"""

from __future__ import annotations

import contextlib
import threading
from pathlib import Path
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named span shown inside profiler traces; a no-op context while no
    profiler records on this thread."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


# Ops whose output is uninitialised memory (or a tensor made from another's
# storage), which may hold NaN bits that no computation produced.
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided", "set_", "resize_")

_NAN_STATE = threading.local()


class _NanCheckMode(TorchDispatchMode):
    """Checks every floating output of every ATen op for NaN while
    ``nan_check`` is on in this thread. The ops inside ``__torch_dispatch__``
    run below the mode, so the check itself is not checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(_NAN_STATE, "enabled", False) and func.__name__.split(".")[0] not in _UNINITIALISED:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_check(enable: bool = True) -> Iterator[None]:
    """Raise ``FloatingPointError`` where an op produces a NaN, while active.

    The forward is checked op by op by a dispatch mode (each check reads one
    flag back from the device, so it serialises a CUDA stream: a debugging
    tool); the backward by autograd's anomaly mode, which raises where a
    backward function returns NaN. ``nan_check(False)`` inside an active
    check turns it off for its body. A hand-written CUDA kernel writes its
    output outside the dispatcher, so a NaN it makes is caught at the next
    op that reads it. The previous state comes back on exit.
    """
    prev = getattr(_NAN_STATE, "enabled", False)
    prev_anomaly = torch.is_anomaly_enabled()
    _NAN_STATE.enabled = enable
    torch.autograd.set_detect_anomaly(enable)
    try:
        with _NanCheckMode() if enable else contextlib.nullcontext():
            yield
    finally:
        _NAN_STATE.enabled = prev
        torch.autograd.set_detect_anomaly(prev_anomaly)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """bytes_in_use / peak_bytes_in_use per CUDA device, from the caching
    allocator (``torch.cuda.memory_stats``); an empty dict without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        }
    return stats

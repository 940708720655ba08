"""A profiled slice of a run, reduced in memory to what the metrics read.

The harness stamps each call it makes into the program with the wall clock
(``time.time_ns()``, the profiler's own time base; a marker event at the
start measures any offset). ``Profiler`` runs ``torch.profiler`` over some of
those calls, the device alone or with the host operations, and ``reduce``
keeps: the window (from the start of the first whole call to the start of the
call after the last), the device's busy seconds in it (the union of kernels,
copies and sets), every kernel's name and duration, the device operations
that took most time, and the idle gaps by the host operation running in
them. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARK = "rfbench.clock"
_NOT_KERNEL = re.compile(r"^(Memcpy|Memset)", re.I)


@dataclass
class Summary:
    calls: List[int]               # indices of the whole calls in the window
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]] = field(default_factory=list)  # (name, seconds)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def kernel_seconds(self, pattern: str) -> Tuple[int, float]:
        """(count, seconds) of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [d for n, d in self.kernels if rx.search(n)]
        return len(hits), sum(hits)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _HostOps:
    """Host operations by thread, each with its enclosing operation, so that
    the innermost one running at a time is found in a few steps."""

    def __init__(self, ops) -> None:
        self.threads: Dict[int, list] = {}
        for tid, s, e, n in sorted(ops):
            self.threads.setdefault(tid, []).append((s, e, n))
        self.parent, self.starts = {}, {}
        for tid, lst in self.threads.items():
            stack, par = [], []
            for i, (s, e, _) in enumerate(lst):
                while stack and lst[stack[-1]][1] < s:
                    stack.pop()
                par.append(stack[-1] if stack else -1)
                stack.append(i)
            self.parent[tid], self.starts[tid] = par, [s for s, _, _ in lst]

    def running(self, t: int) -> str:
        best = None
        for tid, lst in self.threads.items():
            j = bisect.bisect_right(self.starts[tid], t) - 1
            while j >= 0 and lst[j][1] < t:
                j = self.parent[tid][j]
            if j >= 0 and (best is None or lst[j][0] > best[0]):
                best = lst[j]
        return best[2] if best is not None else "host: no traced operation"


def _short(name: str) -> str:
    """A kernel's name without its trailing parameter list, at most 120
    characters (``void (anonymous namespace)::k<..>(float*)`` keeps its
    namespace)."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def reduce(events, starts: Sequence[int], bounds: Tuple[int, int], top: int = 10
           ) -> Optional[Summary]:
    """Reduce kineto events. ``starts``: each call's start (trace clock, ns);
    ``bounds``: the profiled interval. Whole calls are those that start in
    it and whose next call starts in it too."""
    host, device = [], []
    for e in events:
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if dur <= 0 or name.startswith("rfbench."):
            continue
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((e.start_thread_id(), start, start + dur, name))
        elif not getattr(e, "is_user_annotation", lambda: False)():
            device.append((start, start + dur, name))
    whole = [i for i in range(len(starts) - 1)
             if bounds[0] <= starts[i] and starts[i + 1] <= bounds[1]]
    if not whole or not device:
        return None
    lo, hi = starts[whole[0]], starts[whole[-1] + 1]
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi]
    busy = _union([(a, b) for a, b, _ in inside])
    by_op: Dict[str, float] = {}
    kernels = []
    for a, b, n in inside:
        by_op[_short(n)] = by_op.get(_short(n), 0.0) + (b - a) / 1e9
        if not _NOT_KERNEL.match(n):
            kernels.append((n, (b - a) / 1e9))
    threads = _HostOps(host)
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = threads.running((a + b) // 2)
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9

    def rank(d: Dict[str, float]) -> List[list]:
        return [list(kv) for kv in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return Summary(calls=whole, window_s=(hi - lo) / 1e9,
                   busy_s=sum(b - a for a, b in busy) / 1e9, kernels=kernels,
                   device_ops=rank(by_op), idle_gaps=rank(gaps))


def init() -> None:
    """Start the profiler's machinery on this thread (kineto registers on the
    first thread that uses it) before a ``Profiler`` is entered on another."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pass


class Profiler:
    """``with Profiler(device, host) as p: ...`` then ``p.summary(starts)``
    with the wall-clock starts of the calls made; entered on the thread that
    makes the calls, whose launches it then sees. Without ``host`` only the
    device is traced, which costs the host little, so the window, busy time
    and kernels read as in an untraced run; with it the host operations of
    that thread (and of the autograd threads it starts) are recorded too,
    slower, to name the idle gaps."""

    def __init__(self, device: torch.device, host: bool) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU] if host or device.type != "cuda" else []
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._device = device

    def __enter__(self) -> "Profiler":
        # the trace clock against the wall clock, from a host event of a
        # session of its own (the slice may trace no host events)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as clock:
            mark = time.time_ns()
            with torch.profiler.record_function(MARK):
                pass
        self.offset = next(e.start_ns() for e in clock.profiler.kineto_results.events()
                           if e.name() == MARK) - mark
        self._prof.__enter__()
        self.begin = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.end = time.time_ns()
        self._prof.__exit__(*exc)

    def summary(self, starts: Sequence[int]) -> Optional[Summary]:
        events = self._prof.profiler.kineto_results.events()
        return reduce(events, [s + self.offset for s in starts],
                      (self.begin + self.offset, self.end + self.offset))

"""The reduction of a profiled slice, on made-up events."""

import pytest
import torch

from rfbench import tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Event:
    def __init__(self, name, start, end, device=CUDA, tid=1, annotation=False):
        self._n, self._s, self._e, self._d, self._t, self._a = name, start, end, device, tid, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_window_busy_kernels_and_gaps():
    events = [
        _Event("conv3x3_wgmma_kernel(x)", 100, 300),
        _Event("Memcpy DtoH", 300, 350),
        _Event("gn_silu_fwd_kernel<8>", 500, 600),
        _Event("conv3x3_wgmma_kernel(x)", 900, 1000),  # after the window
        _Event("annotation", 100, 900, annotation=True),
        _Event("aten::cat", 350, 500, device=CPU, tid=7),
        _Event("aten::copy_", 360, 380, device=CPU, tid=7),
        _Event("rfbench.clock", 0, 1, device=CPU),
    ]
    # calls start at 100, 700 and 1100; the profiled interval holds the first two
    s = tracing.reduce(events, [50, 100, 700, 1100], (60, 1000))
    assert s.calls == [1]
    assert s.window_s == pytest.approx(600e-9)
    assert s.busy_s == pytest.approx(350e-9)
    assert s.kernel_seconds("conv3x3") == (1, pytest.approx(200e-9))
    assert len(s.kernels) == 2  # the copy is busy time, not a kernel
    gaps = dict((k, v) for k, v in s.idle_gaps)
    assert gaps["aten::cat"] == pytest.approx(150e-9)
    assert gaps["host: no traced operation"] == pytest.approx(100e-9)
    assert s.device_ops[0][0] == "conv3x3_wgmma_kernel"


def test_nothing_to_read():
    assert tracing.reduce([_Event("k", 0, 10)], [5], (0, 20)) is None
    assert tracing.reduce([], [0, 10, 20], (0, 30)) is None


def test_serve_readers_take_the_calls_time_not_the_offered_rate():
    from rfbench import core, roofline

    cell = core.cell("unet64.serve.p60-s4")
    rec = lambda n, s, k: {"images": n, "launches": {}, "seconds": s,  # noqa: E731
                           "batcher": {"batches": k, "latency_sum_s": 0.1 * k}}
    calls = [rec(40, 0.1, 0), rec(10, 0.1, 1), rec(300, 0.1, 2), rec(3, 0.1, 4)]
    # the traced calls are the middle two (three batches; the device ran 0.18 s);
    # the measured window had 10 batches in 1.2 s of calls and returned 1200 images
    summary = tracing.Summary(calls=[1, 2], window_s=0.5, busy_s=0.18)
    timed = [rec(100, 0.1, k) for k in range(8)] + [rec(200, 0.2, 8 + k) for k in range(2)]
    obs = core.Observed(cell.config, cell.traffic, summary, calls, 0, rate=1.0, timed=timed)
    f = roofline.model_flops(cell.config)
    want = 100 * 1200 * 4 * f["velocity"] / 1.2 / roofline.BF16_FLOPS
    assert core.metric_reader("mfu.serve")(obs) == pytest.approx(want)
    assert core.metric_reader("device_idle_share.serve")(obs) == pytest.approx(50.0)
    assert core.metric_reader("batcher_call_ms.serve")(obs) == pytest.approx(100.0)
    obs.rate = 1e6  # an offered rate moves none of them
    assert core.metric_reader("mfu.serve")(obs) == pytest.approx(want)

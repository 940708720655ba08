"""The port's spans and counters on the CPU.

Spans (``utils.profiling.annotate``): no ``record_function`` is entered
while no profiler records; under ``torch.profiler`` a ``generate`` call and
a ``make_train_epoch`` call open the named spans, each phase inside its
parent by interval. Counters (``Batcher.stats``, the service's dict): every
key from construction, queue and wake counts equal to the requests, padded
rows as whole batches less images, the service's counters copied into the
batcher's after each call, a failed call's requests queued and woken but not
served, and copies taken on another thread during the submits.
"""

import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu_torch import serving_http as H
from rectified_flow_vision_tpu_torch.models import BaseFlowModel
from rectified_flow_vision_tpu_torch.models import base_flow as TBF
from rectified_flow_vision_tpu_torch.serving import SamplerService
from rectified_flow_vision_tpu_torch.utils import profiling as TP

TINY = dict(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1,
            sample_dtype="float32", seed=0)
BATCHER_KEYS = {"requests", "images", "batches", "latency_sum_s", "latency_max_s",
                "queued_requests", "queue_wait_sum_s", "woken_requests", "wake_sum_s"}
SERVICE_KEYS = {"generate_calls", "enqueue_sum_s", "device_wait_sum_s", "to_host_sum_s",
                "padded_images", "cond_rows", "cond_sum_s"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six xdist workers share the cores: two OpenMP threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _service(step_counts=(1, 2), batch_size=4):
    model = BaseFlowModel(device="cpu", **TINY)
    return SamplerService(model, step_counts=step_counts, batch_size=batch_size, warmup=False)


def _train_epoch(dropout=0.1):
    model = BaseFlowModel(device="cpu", **dict(TINY, dropout=dropout))
    opt = TBF.make_optimizer(model, 1e-3, epochs=1, steps_per_epoch=2)
    ema = TBF.init_ema(model)
    epoch = TBF.make_train_epoch(model, opt, coupled=False, ema=ema, ema_decay=0.9)
    corpus = torch.tanh(torch.randn(8, 8, 8, 3, generator=torch.Generator().manual_seed(0)))
    perm = torch.arange(8).view(2, 4)
    return epoch, corpus, perm


def _spans(prof):
    """(name, start, end) of every ``rfv.*`` span the profiler recorded."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("rfv.")]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


# ---- spans -------------------------------------------------------------------


def test_annotate_enters_no_record_function_while_nothing_records(monkeypatch):
    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    assert not torch.autograd._profiler_enabled()
    with TP.annotate("rfv.test") as span:
        assert span is None
    assert TP.annotate("rfv.a") is TP.annotate("rfv.b")  # one shared no-op context
    svc = _service()
    assert svc.generate(3, num_steps=2).shape == (3, 3, 8, 8)
    epoch, corpus, perm = _train_epoch()
    assert torch.isfinite(epoch(corpus, perm, torch.Generator().manual_seed(1))).all()


@pytest.mark.parametrize("n,batches", [(3, 1), (6, 2)])
def test_generate_spans_nest(n, batches):
    """One ``rfv.generate`` holds two ``rfv.sampler.step`` a batch, a noise
    draw a batch, then one device wait and one copy, in that order."""
    svc = _service(batch_size=4)
    spans = _profiled(lambda: svc.generate(n, num_steps=2))
    names = [s[0] for s in spans]
    (call,) = [s for s in spans if s[0] == "rfv.generate"]
    assert names.count("rfv.sampler.step") == 2 * batches
    assert names.count("rfv.generate.noise") == batches
    assert names.count("rfv.generate.device_wait") == 1
    assert names.count("rfv.generate.to_host") == 1
    assert "rfv.decode" not in names  # a pixel service decodes nothing
    assert all(_inside(s, call) for s in spans if s is not call)
    (wait,) = [s for s in spans if s[0] == "rfv.generate.device_wait"]
    (copy,) = [s for s in spans if s[0] == "rfv.generate.to_host"]
    last_step = max(s[2] for s in spans if s[0] == "rfv.sampler.step")
    assert last_step <= wait[1] and wait[2] <= copy[1]


def test_train_epoch_spans_nest():
    """Two steps: two gathers and two ``rfv.train.step``, each holding its
    loss, backward, optimizer and EMA, in that order and no other step's."""
    epoch, corpus, perm = _train_epoch()
    spans = _profiled(lambda: epoch(corpus, perm, torch.Generator().manual_seed(1)))
    steps = sorted(s for s in spans if s[0] == "rfv.train.step")
    gathers = sorted(s for s in spans if s[0] == "rfv.train.gather")
    assert len(steps) == 2 and len(gathers) == 2
    for gather, step in zip(gathers, steps):
        assert gather[2] <= step[1]  # the batch is gathered before its step
    phases = ["rfv.train.loss", "rfv.train.backward", "rfv.train.optimizer", "rfv.train.ema"]
    for step in steps:
        inner = sorted((s for s in spans if s[0] in phases and _inside(s, step)),
                       key=lambda s: s[1])
        assert [s[0] for s in inner] == phases
        assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    assert sum(s[0] in phases for s in spans) == 2 * len(phases)


# ---- counters ------------------------------------------------------------------


def test_every_counter_exists_at_construction():
    svc = _service()
    batcher = H.Batcher(svc)
    try:
        assert set(batcher.stats) == BATCHER_KEYS | SERVICE_KEYS
        assert set(svc.stats) == SERVICE_KEYS  # the service keeps only its own
        assert all(v == 0 for v in batcher.stats.values())
        snap = batcher.snapshot()
        assert snap == batcher.stats and snap is not batcher.stats
    finally:
        batcher.shutdown()

    class Bare:  # a service without counters of its own
        step_counts = (1,)

    bare = H.Batcher(Bare())
    bare.shutdown()
    assert set(bare.stats) == BATCHER_KEYS


def test_concurrent_submits_are_counted():
    """N senders: N queued and N woken; padding is whole batches less the
    images of each call; copies on another thread never meet an insertion;
    the service's split of a call lies within the batcher's call time."""
    svc = _service(step_counts=(1,), batch_size=4)
    calls = []
    generate = svc.generate

    def recorded(n, num_steps=None, **kw):
        calls.append(n)
        return generate(n, num_steps=num_steps, **kw)

    svc.generate = recorded
    batcher = H.Batcher(svc, max_wait_ms=20.0)
    stop, copy_errors, copies = threading.Event(), [], [0]

    def copier():
        while not stop.is_set():
            try:
                dict(batcher.stats)
                copies[0] += 1
                time.sleep(1e-4)  # leave the GIL to the senders between copies
            except Exception as e:  # pragma: no cover - the failure under test
                copy_errors.append(e)

    sizes = [1, 3, 2, 5, 1, 4, 2, 3]
    errors = []

    def sender(k):
        try:
            assert batcher.submit(k, 1).shape[0] == k
        except Exception as e:  # pragma: no cover
            errors.append(e)

    watcher = threading.Thread(target=copier)
    watcher.start()
    threads = [threading.Thread(target=sender, args=(k,)) for k in sizes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop.set()
    watcher.join(timeout=30)
    batcher.shutdown()
    s = batcher.snapshot()
    n = len(sizes)
    assert not errors and not copy_errors and copies[0] > 0
    assert s["requests"] == s["queued_requests"] == s["woken_requests"] == n
    assert s["images"] == sum(sizes) == sum(calls)
    assert s["batches"] == s["generate_calls"] == len(calls)
    assert s["padded_images"] == sum(math.ceil(c / 4) * 4 - c for c in calls)
    assert {k: s[k] for k in SERVICE_KEYS} == svc.stats  # copied after the last call
    assert s["queue_wait_sum_s"] >= 0.019  # the first request waited out a 20 ms sleep
    assert s["wake_sum_s"] >= 0
    split = s["enqueue_sum_s"] + s["device_wait_sum_s"] + s["to_host_sum_s"]
    assert 0 < split <= s["latency_sum_s"]


def test_failed_requests_are_counted():
    """A call that raises: its requests count as queued and woken, and
    nothing as served."""
    class Failing:
        step_counts = (1,)
        cond_shapes = None

        def generate(self, n, num_steps, cond=None):
            raise RuntimeError("sampler down")

    batcher = H.Batcher(Failing(), max_wait_ms=30.0)
    errs = []

    def worker():
        try:
            batcher.submit(1, 1, timeout=60)
        except RuntimeError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    batcher.shutdown()
    s = batcher.snapshot()
    assert errs == ["sampler down"] * 3
    assert s["queued_requests"] == s["woken_requests"] == 3
    assert s["batches"] == s["requests"] == s["images"] == s["latency_sum_s"] == 0


def test_counts_survive_a_thread_stress():
    """More senders than cores and a short switch interval: no update of a
    counter is lost (each count equals the requests sent, the images their
    sum, the service's padding, copied in, whole batches less images)."""
    class Zeros:
        step_counts = (1,)
        cond_shapes = None

        def __init__(self):
            self.calls = []
            self.stats = {"padded_images": 0}

        def generate(self, n, num_steps, cond=None):
            self.calls.append(n)
            self.stats["padded_images"] += -(-n // 4) * 4 - n
            return np.zeros((n, 1), np.float32)

    svc = Zeros()
    batcher = H.Batcher(svc, max_wait_ms=0.0)
    senders, each = 4 * (os.cpu_count() or 2), 10
    errors = []

    def sender(i):
        try:
            for j in range(each):
                assert batcher.submit(1 + (i + j) % 3, 1, timeout=60).shape[0] == 1 + (i + j) % 3
        except Exception as e:  # pragma: no cover - the failure under test
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=sender, args=(i,)) for i in range(senders)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
        batcher.shutdown()
    s = batcher.snapshot()
    n = senders * each
    assert not errors
    assert s["requests"] == s["queued_requests"] == s["woken_requests"] == n
    assert s["images"] == sum(1 + (i + j) % 3 for i in range(senders) for j in range(each))
    assert s["batches"] == len(svc.calls)
    assert s["padded_images"] == sum(-(-c // 4) * 4 - c for c in svc.calls)

"""The readers of the program's serving counters, on made-up call records:
each difference of sums over the difference of its count between the first
and the last call of the window, and ``None`` where the count did not move
or the program keeps no such counter."""

import pytest

from rfbench import core

FIRST = {"requests": 10, "images": 100, "batches": 4, "latency_sum_s": 0.3,
         "queued_requests": 10, "queue_wait_sum_s": 0.2, "woken_requests": 9, "wake_sum_s": 0.009,
         "padded_images": 924, "generate_calls": 4, "enqueue_sum_s": 0.04,
         "device_wait_sum_s": 0.2, "to_host_sum_s": 0.004}
LAST = {"requests": 30, "images": 400, "batches": 8, "latency_sum_s": 0.6,
        "queued_requests": 30, "queue_wait_sum_s": 0.8, "woken_requests": 29, "wake_sum_s": 0.019,
        "padded_images": 1548, "generate_calls": 8, "enqueue_sum_s": 0.1,
        "device_wait_sum_s": 0.42, "to_host_sum_s": 0.012}
EXPECTED = {
    "queue_wait_ms.serve": 1e3 * 0.6 / 20,
    "wake_ms.serve": 1e3 * 0.010 / 20,
    "enqueue_ms.serve": 1e3 * 0.06 / 4,
    "to_host_ms.serve": 1e3 * 0.008 / 4,
    "pad_share.serve": 100.0 * 624 / (624 + 300),
}


class _Run:
    def __init__(self, *batchers):
        self.timed = [{"images": 1, "batcher": b} for b in batchers]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_mean_over_the_window(name):
    read = core.metric_reader(name)
    assert read(_Run(FIRST, {}, LAST)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_where_nothing_moved(name):
    read = core.metric_reader(name)
    assert read(_Run(FIRST)) is None  # one call: no difference
    assert read(_Run(FIRST, FIRST)) is None
    # the parent's records: the batcher's first five counters only
    old = {k: FIRST[k] for k in ("requests", "images", "batches", "latency_sum_s")}
    new = {k: LAST[k] for k in old}
    assert read(_Run(old, new)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_read_in_both_serve_cells(name):
    serve = {w["name"] for w in core.manifest()["workloads"] if ".serve." in w["name"]}
    for cell in serve:
        assert name in {m["name"] for m in core.cell(cell).per_layer}

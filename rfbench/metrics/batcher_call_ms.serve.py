"""Mean time of one call of the batcher into the service, in ms: the
program's own counters (``Batcher.stats``: ``latency_sum_s`` over
``batches``), read at the start of the first and of the last call of the
measured window, which ran without the profiler."""


def read(run):
    if len(run.timed) < 2:
        return None
    a, b = run.timed[0]["batcher"], run.timed[-1]["batcher"]
    n = b.get("batches", 0) - a.get("batches", 0)
    if n <= 0:
        return None
    return 1e3 * (b["latency_sum_s"] - a["latency_sum_s"]) / n

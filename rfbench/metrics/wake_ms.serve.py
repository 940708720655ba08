"""Mean time from a request's ``done.set()`` on the batcher thread to its
sender running again in ``Batcher.submit``, in ms. The program's own
counters (``Batcher.stats``: ``wake_sum_s`` over ``woken_requests``), read
at the start of the first and of the last call of the measured window, which
ran without the profiler; ``None`` where the count did not move (a program
without these counters)."""


def read(run):
    if len(run.timed) < 2:
        return None
    a, b = run.timed[0]["batcher"], run.timed[-1]["batcher"]
    n = b.get("woken_requests", 0) - a.get("woken_requests", 0)
    if n <= 0:
        return None
    return 1e3 * (b["wake_sum_s"] - a["wake_sum_s"]) / n

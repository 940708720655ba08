"""Mean wait of a request in the batcher's queue, in ms: from its enqueue in
``Batcher.submit`` to the take of its group (the coalescing sleep and the
wait behind a call already running). The program's own counters
(``Batcher.stats``: ``queue_wait_sum_s`` over ``queued_requests``), read at
the start of the first and of the last call of the measured window, which
ran without the profiler; ``None`` where the count did not move (a program
without these counters)."""


def read(run):
    if len(run.timed) < 2:
        return None
    a, b = run.timed[0]["batcher"], run.timed[-1]["batcher"]
    n = b.get("queued_requests", 0) - a.get("queued_requests", 0)
    if n <= 0:
        return None
    return 1e3 * (b["queue_wait_sum_s"] - a["queue_wait_sum_s"]) / n

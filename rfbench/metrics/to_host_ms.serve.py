"""Mean time of one ``SamplerService.generate`` call's copy of its images to
the host, after the stream synchronise, in ms. The program's own counters
(``SamplerService.stats``, copied into the batcher's dict after each call:
``to_host_sum_s`` over ``generate_calls``), read at the start of the first
and of the last call of the measured window, which ran without the profiler;
``None`` where the count did not move (a program without these counters)."""


def read(run):
    if len(run.timed) < 2:
        return None
    a, b = run.timed[0]["batcher"], run.timed[-1]["batcher"]
    n = b.get("generate_calls", 0) - a.get("generate_calls", 0)
    if n <= 0:
        return None
    return 1e3 * (b["to_host_sum_s"] - a["to_host_sum_s"]) / n

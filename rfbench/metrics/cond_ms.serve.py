"""Mean time of one ``SamplerService.generate`` call staging its prompts'
conditioning rows on the device, in ms: each batch's rows copied from the
host, the last repeated into the padding rows. The program's own counters
(``SamplerService.stats``, copied into the batcher's dict after each call:
``cond_sum_s`` over ``generate_calls``), read at the start of the first and
of the last call of the measured window, which ran without the profiler;
``None`` where the count did not move or the program keeps no
``cond_sum_s``."""


def read(run):
    if len(run.timed) < 2:
        return None
    a, b = run.timed[0]["batcher"], run.timed[-1]["batcher"]
    n = b.get("generate_calls", 0) - a.get("generate_calls", 0)
    if n <= 0 or "cond_sum_s" not in a or "cond_sum_s" not in b:
        return None
    return 1e3 * (b["cond_sum_s"] - a["cond_sum_s"]) / n

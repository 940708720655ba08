"""Mean host time of one ``SamplerService.generate`` call before its stream
synchronise, in ms: drawing the noise and issuing the sampler's, the
decode's and the clamp's launches. Host time alone only while the launch
queue has room: where it fills (a DiT call's host blocks on "Command Buffer
Full"), the host waits for the device inside this span, so device time
counts here too. The program's own counters (``SamplerService.stats``,
copied into the batcher's dict after each call: ``enqueue_sum_s`` over
``generate_calls``), read at the start of the first and of the last call of
the measured window, which ran without the profiler; ``None`` where the count
did not move (a program without these counters)."""


def read(run):
    if len(run.timed) < 2:
        return None
    a, b = run.timed[0]["batcher"], run.timed[-1]["batcher"]
    n = b.get("generate_calls", 0) - a.get("generate_calls", 0)
    if n <= 0:
        return None
    return 1e3 * (b["enqueue_sum_s"] - a["enqueue_sum_s"]) / n

"""Share of the rows the service computed that no request got back, in %:
a call pays whole batches of the service's batch size. The program's own
counters (``SamplerService.stats``' ``padded_images``, copied into the
batcher's dict after each call, over itself plus the batcher's ``images``),
read at the start of the first and of the last call of the measured window,
which ran without the profiler; ``None`` where no row was computed or the
program keeps no ``padded_images``."""


def read(run):
    if len(run.timed) < 2:
        return None
    a, b = run.timed[0]["batcher"], run.timed[-1]["batcher"]
    if "padded_images" not in a or "padded_images" not in b:
        return None
    padded = b["padded_images"] - a["padded_images"]
    rows = padded + b["images"] - a["images"]
    if rows <= 0:
        return None
    return 100.0 * padded / rows

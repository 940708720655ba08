"""Model FLOPs of the images that the measured window's batcher calls
returned, over those calls' time, as a share of the bf16 dense peak: each
returned image's FLOPs (``num_steps`` forwards of the velocity network and,
on the latent path, one decode; the reference's at the cell's shapes,
``roofline.model_flops``) over the summed time from each call's start to its
output on the host. The window's calls run without the profiler, and there
are some hundreds of them, so the reading is steady. Padding rows do no
useful work and are not counted, and the host's share of a call counts as
time, so both lower it. Time between calls, waiting for arrivals, does not
count: the metric reads how fast a call serves, which a request waits on."""

from rfbench import roofline


def read(run):
    seconds = sum(c["seconds"] for c in run.timed)
    if seconds <= 0:
        return None
    f = roofline.model_flops(run.config)
    per_image = run.traffic["num_steps"] * f["velocity"] + f["decode"]
    images = sum(c["images"] for c in run.timed)
    return 100.0 * images * per_image / seconds / roofline.BF16_FLOPS

"""Model FLOPs trained a second in the measured window, as a share of the
bf16 dense peak: the window's ``train_img_per_s`` times 3x an image's
forward FLOPs (forward and backward; a recomputed forward is not counted)."""

from rfbench import roofline


def read(run):
    return 100.0 * run.rate * 3.0 * roofline.model_flops(run.config)["velocity"] / roofline.BF16_FLOPS

"""The bf16 GroupNorm + SiLU (+ dropout) backward kernels' share of their
roofline in the traced window: the least time of their calls (29 sites a
UNet train step, shapes at the train batch; calls counted by the program's
launch counter) over the device time of the kernels named below (the
backward and its per-image parameter-gradient sum). A program that renames
or replaces them leaves this metric silent until a benchmark change points
it at the new names."""

from rfbench import roofline
from rfbench.reference import unet

KERNELS = r"gn_silu_bwd_kernel|gn_silu_bwd_params_kernel"


def read(run):
    sites = unet.kernel_sites(run.config["model"], run.traffic["batch"])["gn_silu"]
    count, seconds = run.summary.kernel_seconds(KERNELS)
    calls = run.launches("gn_silu_backward")
    if not count or not calls:
        return None
    return roofline.share(calls / len(sites) * roofline.gn_silu_backward_least(sites), seconds)

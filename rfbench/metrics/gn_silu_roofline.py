"""The bf16 ``gn_silu`` forward kernel's share of its roofline in the traced
window: the least time of its calls (29 sites a UNet forward in eval mode,
shapes at the service batch; calls counted by the program's launch counter)
over the device time of the kernels named below. A program that renames or
replaces the kernel leaves this metric silent until a benchmark change
points it at the new name."""

from rfbench import roofline
from rfbench.reference import unet

KERNELS = r"gn_silu_fwd_kernel"


def read(run):
    sites = unet.kernel_sites(run.config["model"], run.traffic["service_batch"])["gn_silu"]
    count, seconds = run.summary.kernel_seconds(KERNELS)
    calls = run.launches("gn_silu")
    if not count or not calls:
        return None
    return roofline.share(calls / len(sites) * roofline.gn_silu_least(sites), seconds)

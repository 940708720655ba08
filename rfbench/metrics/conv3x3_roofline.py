"""The bf16 ``conv3x3`` kernel's share of its roofline in the traced window:
the least time of its calls (30 sites a UNet forward, shapes from the
configuration at the service batch; calls counted by the program's launch
counter) over the device time of the kernels named below. A program that
renames or replaces the kernel leaves this metric silent until a benchmark
change points it at the new name."""

from rfbench import roofline
from rfbench.reference import unet

KERNELS = r"conv3x3_wgmma_kernel"


def read(run):
    sites = unet.kernel_sites(run.config["model"], run.traffic["service_batch"])["conv3x3"]
    count, seconds = run.summary.kernel_seconds(KERNELS)
    calls = run.launches("conv3x3")
    if not count or not calls:
        return None
    return roofline.share(calls / len(sites) * roofline.conv3x3_least(sites), seconds)

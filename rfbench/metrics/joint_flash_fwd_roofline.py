"""The bf16 flash-attention forward kernel's share of its roofline in the
traced window of a FLUX cell: the least time of its calls (one a block,
double and single, over the joint sequence of text and image tokens, at the
service batch; calls counted by the program's launch counter) over the
device time of the kernel named below. ``flash_fwd_roofline`` derives a
DiT's token count and would misread this cell. A program that renames or
replaces the kernel leaves this metric silent until a benchmark change
points it at the new name."""

from rfbench import roofline
from rfbench.reference import flux

KERNELS = r"flash_fwd_wgmma_kernel"


def read(run):
    shape = flux.flash_calls(run.config["model"], run.traffic["service_batch"])[0]
    count, seconds = run.summary.kernel_seconds(KERNELS)
    calls = run.launches("flash_attention")
    if not count or not calls:
        return None
    return roofline.share(calls * roofline.flash_forward_least([shape]), seconds)

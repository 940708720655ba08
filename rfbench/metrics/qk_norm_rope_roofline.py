"""The bf16 ``qk_norm_rope`` kernel's share of its roofline in the traced
window: the least time of its launches (a double block's text and image
streams, a single block's joint one, ``reference.flux.qk_norm_rope_sites``
at the service batch; launches counted by the program's launch counter) over
the device time of the kernel named below. Bound by bytes: the stream's qkv
read and q, k, v written in bf16, the fp32 cos and sin rows of its tokens and
the two scales read, each byte once. A program without the kernel (or one
that renames it) leaves this metric silent."""

from rfbench import roofline
from rfbench.reference import flux

KERNELS = r"qk_norm_rope_kernel"


def least_s(sites) -> float:
    total = 0.0
    for b, t, c, d in sites:
        nbytes = roofline.BF16 * 2 * b * t * 3 * c + roofline.FP32 * (t * d + 2 * d)
        total += roofline.least_s(0.0, nbytes)
    return total


def read(run):
    sites = flux.qk_norm_rope_sites(run.config["model"], run.traffic["service_batch"])
    count, seconds = run.summary.kernel_seconds(KERNELS)
    calls = run.launches("qk_norm_rope")
    if not count or not calls:
        return None
    return roofline.share(calls / len(sites) * least_s(sites), seconds)

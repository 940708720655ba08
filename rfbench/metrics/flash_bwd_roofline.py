"""The bf16 flash-attention backward kernels' share of their roofline in the
traced window: the least time of their calls (one a DiT block and train
step, at the train batch; calls counted by the program's launch counter)
over the device time of the kernels named below (delta, dkv, dq). A program
that renames or replaces them leaves this metric silent until a benchmark
change points it at the new names."""

from rfbench import roofline
from rfbench.reference import dit

KERNELS = r"flash_delta_kernel|flash_dkv_|flash_dq_"


def read(run):
    shape = dit.flash_calls(run.config["model"], run.traffic["batch"])[0]
    count, seconds = run.summary.kernel_seconds(KERNELS)
    calls = run.launches("flash_attention_backward")
    if not count or not calls:
        return None
    return roofline.share(calls * roofline.flash_backward_least([shape]), seconds)

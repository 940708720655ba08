"""The yardstick's arithmetic: the card's peaks, a call's least time, and the
model's FLOPs.

Peaks are NVIDIA's published dense rates for one H100 SXM at its full power
limit of 700 W: 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM
bandwidth. A card set to a lower limit reads lower shares; the run prints the
card's limit beside them.

A call's least time is the larger of its FLOPs at the bf16 peak and its bytes
at the HBM peak, each input byte read once and each output byte written once.
The model's FLOPs are counted by ``torch.utils.flop_counter`` over the
benchmark's own reference at the cell's shapes, on the meta device, so they
are the same whatever implements the model.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch.utils.flop_counter import FlopCounterMode

from rfbench.reference import flow
from rfbench.reference.numerics import Numerics

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2
FP32 = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def share(least: float, measured: float):
    """least / measured in %, or None when nothing was measured."""
    return None if measured <= 0 else 100.0 * least / measured


def conv3x3_least(sites: Iterable[tuple]) -> float:
    """bf16 3x3 conv + fp32 bias, NHWC: x in, weight, bias, y out."""
    total = 0.0
    for b, h, w, cin, cout in sites:
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = BF16 * (b * h * w * (cin + cout) + 9 * cin * cout) + FP32 * cout
        total += least_s(flops, nbytes)
    return total


def gn_silu_least(sites: Iterable[tuple], groups: int = 8) -> float:
    """bf16 GroupNorm + SiLU forward: x in, y out, fp32 affine and statistics."""
    total = 0.0
    for b, h, w, c in sites:
        total += least_s(0.0, BF16 * 2 * b * h * w * c + FP32 * (2 * c + 2 * b * groups))
    return total


def gn_silu_backward_least(sites: Iterable[tuple], groups: int = 8) -> float:
    """bf16 GroupNorm + SiLU (+ dropout) backward: x and the cotangent in, dx
    out; fp32 affine and saved statistics in, their gradients out."""
    total = 0.0
    for b, h, w, c in sites:
        total += least_s(0.0, BF16 * 3 * b * h * w * c + FP32 * (4 * c + 2 * b * groups))
    return total


def flash_forward_least(calls: Iterable[tuple]) -> float:
    """bf16 attention forward: QK^T and PV; q, k, v in, o and the fp32
    log-sum-exp out."""
    total = 0.0
    for b, t, h, d in calls:
        total += least_s(4.0 * b * h * t * t * d, BF16 * 4 * b * t * h * d + FP32 * b * h * t)
    return total


def flash_backward_least(calls: Iterable[tuple]) -> float:
    """bf16 attention backward: S recomputed, dP, dV, dQ, dK (five T x T x D
    products); q, k, v, o, dO and the log-sum-exp in, dq, dk, dv out."""
    total = 0.0
    for b, t, h, d in calls:
        total += least_s(10.0 * b * h * t * t * d, BF16 * 8 * b * t * h * d + FP32 * b * h * t)
    return total


def model_flops(config: dict) -> dict:
    """FLOPs of one image through the velocity network's forward and, on the
    latent path, the decode."""
    mods = flow.skeleton(config)
    m = config["model"]
    net = mods["velocity_net"]
    x = torch.empty((1, m["image_size"], m["image_size"], m["in_channels"]), device="meta")
    out = {}
    with FlopCounterMode(display=False) as fc:
        net.velocity(x, torch.empty((1,), device="meta"), Numerics())
    out["velocity"] = float(fc.get_total_flops())
    out["decode"] = 0.0
    if "vae" in mods:
        with FlopCounterMode(display=False) as fc:
            mods["vae"].decode(torch.empty((1, m["image_size"], m["image_size"],
                                            m["in_channels"]), device="meta"), Numerics())
        out["decode"] = float(fc.get_total_flops())
    return out

"""Arithmetic of the reference: exact float32, or the fp8 control.

Every product of two tensors in the reference (convolutions, dense layers,
the attention matmuls) goes through one ``Numerics`` object. ``Numerics()``
is float32 with TF32 off (``exact_fp32``). ``Numerics(fp8=True)`` rounds both
operands of every product to float8 e4m3 with a per-tensor scale, and their
gradients to e5m2, before an fp32 product: the precision one step below the
bf16 that the configurations state, and so the control that the limits must
fail.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """cuBLAS and cuDNN in exact float32 inside (TF32 off), restored on exit."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = prev


def round_fp8(x: Tensor, dtype: torch.dtype, fmax: float) -> Tensor:
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to ``fmax``, and back to x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / fmax, torch.ones_like(amax))
    return ((x / scale).to(dtype).to(x.dtype) * scale).to(x.dtype)


class _Fp8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Numerics:
    """Products of the reference, exact or in emulated fp8."""

    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8

    def q(self, x: Tensor) -> Tensor:
        return _Fp8Operand.apply(x) if self.fp8 else x

    def conv(self, x: Tensor, w: Tensor, b: Tensor, stride: int = 1) -> Tensor:
        """NHWC conv, OIHW weight, symmetric padding k // 2."""
        pad = w.shape[-1] // 2 if w.shape[-1] % 2 else 0
        y = F.conv2d(self.q(x.permute(0, 3, 1, 2)), self.q(w), b, stride=stride, padding=pad)
        return y.permute(0, 2, 3, 1)

    def linear(self, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(self.q(x), self.q(w).t()) + b

    def matmul(self, a: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(self.q(a), self.q(b))

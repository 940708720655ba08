"""Standalone inverted dropout: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``rectified_flow_vision_tpu/ops/pallas_kernels.py``
``dropout`` (``x``, a one-element int32 seed, a static ``rate``): an element
is kept where its 32 random bits are below keep * 2^32, and kept values are
x * fp32(1 / keep), rounded once. Bound by bytes on the H100
(``csrc/dropout.cu``).

No model path of either package calls it (the UNet fuses its dropout into
``gn_silu_dropout``, DiT has none); it is what ``ops.primitives.dropout``
takes for a CUDA tensor. The TPU kernel's hardware bits cannot be replayed,
so parity is by contract, and the bits are the port's own
(``ops/gn_silu_dropout.py``): Philox of (seed, index along the first axis,
element within it). The plain version gives the kernel's mask bit for bit on
any device, and the gradient is the same function of the cotangent.
"""

from __future__ import annotations

import torch

from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D

Tensor = torch.Tensor


def dropout_plain(x: Tensor, seed: D.Seed, rate: float) -> Tensor:
    """x * mask / keep in fp32, rounded once to x's dtype."""
    return D.dropout_mask_apply_plain(x, seed, rate)


def dropout_cuda(x: Tensor, seed: D.Seed, rate: float) -> Tensor:
    """Launch the CUDA kernel. x: any shape with at least one axis, bf16 or
    fp32, contiguous; seed: int or (1,) int32 tensor on x's device; 0 < rate < 1."""
    build.require_cuda(x, "dropout")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout: rate {rate} outside (0, 1)")
    if x.ndim < 1:
        raise ValueError("dropout: x needs at least one axis")
    build.require(x, "x", device=x.device, dtype=x.dtype, shape=x.shape)
    b = x.shape[0]
    n = x[0].numel() if b else 0
    if b >= 2**32 or n >= 2**32:
        raise ValueError(f"dropout: shape {tuple(x.shape)} exceeds the 32-bit counter words")
    seed_t = D.seed_tensor(seed, x.device)
    thresh, inv_keep = D.rate_consts(rate)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = build.library().rfv_dropout(
        x.data_ptr(), seed_t.data_ptr(), out.data_ptr(), b, n, thresh, inv_keep,
        build.DTYPE_CODES[x.dtype], build.stream_ptr(x),
    )
    build.check(rc, "dropout")
    build.LAUNCHES["dropout"] += 1
    return out

"""The dropout mask of the UNet's train step, from its seeds, in plain PyTorch.

The program draws one int32 seed per residual block and drops activations by
a counter-based generator, so the mask is a pure function of (seed, image,
element). That function is Philox4x32-10 (Salmon et al., SC 2011): key
(seed, 0x52465644), counter (image, element // 4, 0, 0), output word
element % 4, where element is the index inside one NHWC image. An element is
kept where its word is below ``keep * 2**32`` and then scaled by float32
``1 / keep``. This file computes it from that specification in int64 tensor
arithmetic, on any device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

KEY1 = 0x52465644
_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)
_M32 = 0xFFFFFFFF


def _mul_hi_lo(a: int, b: Tensor) -> Tuple[Tensor, Tensor]:
    """(high, low) 32-bit halves of a * b, b held in int64, split in 16-bit
    halves so that no product overflows."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p_lo, p_hi = a * b_lo, a * b_hi
    mid = p_hi + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox(c: Tuple[Tensor, Tensor, Tensor, Tensor], k0: Tensor, k1: int):
    c0, c1, c2, c3 = c
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device)
    for _ in range(10):
        h0, l0 = _mul_hi_lo(_MUL[0], c0)
        h1, l1 = _mul_hi_lo(_MUL[1], c2)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
        k0, k1 = (k0 + _WEYL[0]) & _M32, (k1 + _WEYL[1]) & _M32
    return c0, c1, c2, c3


def keep_scale(rate: float) -> Tuple[int, float]:
    keep = 1.0 - rate
    return min(int(keep * 2**32), 2**32 - 1), float(np.float32(1.0 / keep))


def dropout_factor(shape, seed: Tensor, rate: float, image0: int = 0) -> Tensor:
    """Per-element factor (0 or 1 / keep, float32) of images ``image0 ..`` of
    an NHWC activation of ``shape``; ``seed`` a one-element int32 tensor."""
    b, per_image = shape[0], int(np.prod(shape[1:]))
    dev = seed.device
    quads = (per_image + 3) // 4
    image = torch.arange(image0, image0 + b, dtype=torch.int64, device=dev)[:, None]
    quad = torch.arange(quads, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    k0 = seed.reshape(()).to(torch.int64) & _M32
    words = torch.stack(torch.broadcast_tensors(*philox((image, quad, zero, zero), k0, KEY1)), -1)
    words = words.reshape(b, quads * 4)[:, :per_image].reshape(tuple(shape))
    thresh, inv_keep = keep_scale(rate)
    return torch.where(words < thresh, inv_keep, 0.0).to(torch.float32)

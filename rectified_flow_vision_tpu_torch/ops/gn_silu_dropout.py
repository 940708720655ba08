"""GroupNorm + SiLU + dropout in one pass, its backward, and the mask
regenerated on a cotangent: CUDA kernels and their plain versions.

Replaces the Pallas TPU kernels ``rectified_flow_vision_tpu/ops/pallas_kernels.py``
``gn_silu_dropout`` and ``dropout_mask_apply``. All are bound by bytes on the
H100 (``csrc/gn_silu_dropout.cu``, ``csrc/gn_silu.cu``): no mask tensor is
ever stored. The forward is gn_silu's one-pass cluster kernel with the mask
folded in; the backward is gn_silu's backward kernel, which regenerates the
mask from the saved int32 seed as it reads the cotangent, so the train step
no longer launches ``dropout_mask_apply`` (it stays, held on the card, for a
caller with a cotangent apart from x).

The TPU kernels draw bits from the core's own generator, which cannot be
replayed, so parity is by contract: an element's 32 bits are a pure function
of (seed, image index, element index within the image). Under tensor
parallelism a rank holds a slice of the channels (``channels`` = (offset,
total)), and an element's index is its place in the whole activation,
pixel * total + offset + channel, so the ranks of one data shard drop what
the unsharded activation would. Under data parallelism each rank runs on
its rows with the seed folded by its data rank (``models/base_flow.py``),
as the JAX package's sharded kernel does. Here that function
is Philox4x32-10 with key = (seed, ``DROPOUT_KEY1``), counter = (image,
element // 4, 0, 0) and lane = element % 4, written once in CUDA
(``csrc/common.cuh``) and once below in PyTorch integer ops. The plain
versions therefore give the kernels' mask bit for bit, on any device: a run
on the CPU and a run on the card with the same seeds drop the same elements.

A seed is one int32: a Python int, or a one-element int32 tensor on x's
device (the kernels read it there, so a seed drawn on the card never comes
to the host).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import gn_silu as G

Tensor = torch.Tensor
Seed = Union[int, Tensor]
Channels = Optional[Tuple[int, int]]  # (offset, total) of a channel slice

DROPOUT_KEY1 = 0x52465644
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def rate_consts(rate: float) -> Tuple[int, float]:
    """(thresh, inv_keep): an element is kept where its bits < thresh, and
    kept values are scaled by fp32 1/keep."""
    keep = 1.0 - float(rate)
    thresh = min(int(keep * 2**32), 2**32 - 1)
    return thresh, float(np.float32(1.0 / keep))


def _mulhilo(a: int, b: Tensor) -> Tuple[Tensor, Tensor]:
    """High and low 32 bits of a * b for a 32-bit constant and 32-bit values
    held in int64. a * b overflows a signed int64, so b goes in 16-bit limbs."""
    lo_part = a * (b & 0xFFFF)  # < 2^48
    hi_part = a * (b >> 16)  # < 2^48
    hi = (hi_part + (lo_part >> 16)) >> 16
    lo = (((hi_part & 0xFFFF) << 16) + (lo_part & _MASK32)) & _MASK32
    return hi, lo


def philox4x32_10(counter, key) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Philox4x32-10 on int64 tensors holding 32-bit words: ``counter`` is
    four broadcastable tensors, ``key`` two tensors or ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def _seed_word(seed: Seed, device: torch.device) -> Tensor:
    """The seed's 32 bits as a one-element int64 tensor on ``device``."""
    if isinstance(seed, Tensor):
        return seed.reshape(1).to(device=device, dtype=torch.int64) & _MASK32
    return torch.tensor([int(seed) & _MASK32], dtype=torch.int64, device=device)


def dropout_bits(shape, seed: Seed, device: torch.device, channels: Channels = None) -> Tensor:
    """The 32 dropout bits of every element of a (B, ..., C) tensor, as int64;
    with ``channels`` = (offset, total), of channels [offset, offset + C) of a
    tensor of ``total`` channels."""
    b = int(shape[0])
    n = 1
    for s in shape[1:]:
        n *= int(s)
    image = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    key = (_seed_word(seed, device), DROPOUT_KEY1)
    c = int(shape[-1])
    off, total = _channel_slice(c, channels)
    quads = -(-n // 4)
    quad = torch.arange(quads, dtype=torch.int64, device=device)
    if total != c:  # a slice's quad (4 of its channels) at its place in the whole tensor
        quad = (4 * quad // c) * (total // 4) + off // 4 + (4 * quad % c) // 4
    words = philox4x32_10((image, quad[None, :], zero, zero), key)
    words = torch.broadcast_tensors(*words)
    return torch.stack(words, dim=-1).reshape(b, quads * 4)[:, :n].reshape(tuple(shape))


def keep_mask(
    shape, seed: Seed, rate: float, device: torch.device, channels: Channels = None
) -> Tensor:
    """Boolean mask of the kept elements."""
    return dropout_bits(shape, seed, device, channels) < rate_consts(rate)[0]


def dropout_mask_apply_plain(g: Tensor, seed: Seed, rate: float, channels: Channels = None) -> Tensor:
    """g * mask / keep in fp32, rounded once to g's dtype."""
    inv_keep = rate_consts(rate)[1]
    keep = keep_mask(g.shape, seed, rate, g.device, channels)
    return torch.where(keep, g.float() * inv_keep, 0.0).to(g.dtype)


def gn_silu_dropout_plain(
    x: Tensor, scale: Tensor, bias: Tensor, seed: Seed, rate: float,
    *, num_groups: int = 8, eps: float = 1e-5, channels: Channels = None,
) -> Tensor:
    """dropout(silu(group_norm(x))) in plain PyTorch, with the kernel's mask."""
    act = G.gn_silu_plain(x, scale, bias, num_groups=num_groups, eps=eps)
    return dropout_mask_apply_plain(act, seed, rate, channels)


def seed_tensor(seed: Seed, device: torch.device) -> Tensor:
    """The seed as the (1,) int32 tensor on ``device`` that the kernels read."""
    if isinstance(seed, Tensor):
        build.require(seed, "seed", device=device, dtype=torch.int32, shape=(1,))
        return seed
    word = int(seed) & _MASK32
    return torch.tensor([word - 2**32 if word >= 2**31 else word], dtype=torch.int32,
                        device=device)


def _channel_slice(c: int, channels: Channels) -> Tuple[int, int]:
    """(offset, total) of a slice of width ``c``, (0, c) for a whole tensor.
    A slice's offset, width and total are multiples of 4, so that each Philox
    quad lies in one rank."""
    if channels is None:
        return 0, c
    off, total = (int(v) for v in channels)
    if off < 0 or off + c > total or (total != c and (c % 4 or off % 4 or total % 4)):
        raise ValueError(f"channels {channels} do not hold a slice of width {c} "
                         "(offset, width and total multiples of 4)")
    return off, total


def channel_args(x: Tensor, channels: Channels) -> Tuple[int, int]:
    """The kernels' (c_off, c_total): (0, 0) for a whole tensor."""
    off, total = _channel_slice(x.shape[-1], channels)
    return (0, 0) if channels is None else (off, total)


def _check_image_size(kernel: str, b: int, n: int) -> None:
    if n >= 2**32 or b > 65535:
        raise ValueError(
            f"{kernel}: {b} images of {n} elements not supported (needs fewer than "
            "2^32 elements an image and at most 65535 images)"
        )


def gn_silu_dropout_backward_plain(
    x: Tensor, g: Tensor, scale: Tensor, bias: Tensor, stats: Tensor, seed: Seed, rate: float,
    *, num_groups: int = 8, channels: Channels = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dx, dscale, dbias) by the backward kernel's formulas: the cotangent
    times mask / keep in fp32 (not rounded), then ``G.gn_silu_backward_plain``."""
    inv_keep = rate_consts(rate)[1]
    keep = keep_mask(g.shape, seed, rate, g.device, channels)
    gm = torch.where(keep, g.float() * inv_keep, 0.0)
    return G.gn_silu_backward_plain(x, gm, scale, bias, stats, num_groups=num_groups)


def _check_rate(kernel: str, rate: float) -> None:
    if not 0.0 < rate < 1.0:
        raise ValueError(f"{kernel}: rate {rate} outside (0, 1)")


def gn_silu_dropout_cuda(
    x: Tensor, scale: Tensor, bias: Tensor, seed: Seed, rate: float,
    *, num_groups: int = 8, eps: float = 1e-5, channels: Channels = None,
) -> Tuple[Tensor, Tensor]:
    """Launch the forward kernel. x: (B, H, W, C) bf16/fp32; scale, bias: (C,)
    fp32; seed: int or (1,) int32 tensor on x's device; 0 < rate < 1;
    ``channels``: x's place in an unsharded activation. Returns (y, stats),
    stats the saved ``[B, G, 2]``."""
    build.require_cuda(x, "gn_silu_dropout")
    _check_rate("gn_silu_dropout", rate)
    G.check_args("gn_silu_dropout", x, scale, bias, num_groups)
    b, h, w, c = x.shape
    c_off, c_total = channel_args(x, channels)
    _check_image_size("gn_silu_dropout", b, h * w * max(c, c_total))
    seed_t = seed_tensor(seed, x.device)
    thresh, inv_keep = rate_consts(rate)
    stats = torch.empty((b, num_groups, 2), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    rc = build.library().rfv_gn_silu_dropout(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), seed_t.data_ptr(),
        stats.data_ptr(), out.data_ptr(), b, h * w, c, num_groups, eps,
        thresh, inv_keep, c_off, c_total, build.DTYPE_CODES[x.dtype], build.stream_ptr(x),
    )
    build.check(rc, "gn_silu_dropout")
    build.LAUNCHES["gn_silu_dropout"] += 1
    return out, stats


def gn_silu_dropout_backward_cuda(
    x: Tensor, g: Tensor, scale: Tensor, bias: Tensor, stats: Tensor, seed: Seed, rate: float,
    *, num_groups: int = 8, channels: Channels = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the backward kernel with the mask of (seed, x.shape, channels)
    regenerated inside: (dx, dscale, dbias)."""
    build.require_cuda(x, "gn_silu_backward")
    _check_rate("gn_silu_backward", rate)
    chans = channel_args(x, channels)
    _check_image_size("gn_silu_backward", x.shape[0],
                      x[0].numel() // x.shape[-1] * max(x.shape[-1], chans[1]))
    thresh, inv_keep = rate_consts(rate)
    return G.launch_backward(x, g, scale, bias, stats, num_groups,
                             seed_tensor(seed, x.device), thresh, inv_keep, chans)


def dropout_mask_apply_cuda(g: Tensor, seed: Seed, rate: float) -> Tensor:
    """Launch the CUDA kernel: gn_silu_dropout's mask for (seed, g.shape),
    applied to g. g: (B, ...) bf16/fp32, contiguous."""
    build.require_cuda(g, "dropout_mask_apply")
    _check_rate("dropout_mask_apply", rate)
    b = g.shape[0]
    n = g[0].numel()
    _check_image_size("dropout_mask_apply", b, n)
    build.require(g, "g", device=g.device, dtype=g.dtype, shape=g.shape)
    seed_t = seed_tensor(seed, g.device)
    thresh, inv_keep = rate_consts(rate)
    out = torch.empty_like(g)
    rc = build.library().rfv_dropout_mask_apply(
        g.data_ptr(), seed_t.data_ptr(), out.data_ptr(), b, n, thresh, inv_keep,
        build.DTYPE_CODES[g.dtype], build.stream_ptr(g),
    )
    build.check(rc, "dropout_mask_apply")
    build.LAUNCHES["dropout_mask_apply"] += 1
    return out

"""Flash attention, forward and backward: CUDA kernels and their plain versions.

Replaces the Pallas TPU library kernel that the JAX package's DiT calls
(``rectified_flow_vision_tpu/models/dit.py`` ``_attention`` ->
``pallas.ops.tpu.flash_attention`` with its dq and dkv backward kernels):
non-causal multi-head attention over q, k, v ``[B, T, H, D]``, scale
1/sqrt(D), fp32 softmax. Bound by operations on the H100
(``csrc/flash_attention.cu``); nothing of size T^2 reaches device memory.

Head widths: every D with D % 8 == 0 and 8 <= D <= 128 (DiT-S, B and L give
64, XL 72). ``kernel_head_dim`` gives the width the kernels are compiled for
that takes D: the bf16 kernels pad D in shared memory to 64 or 128 (one or
two 128-byte TMA boxes, columns past D zero-filled), the fp32 kernels to the
next multiple of 16.

``use_flash`` is the JAX package's rule on shape (``dit.py:131-135``): the
kernel where T >= 1024 and T % 128 == 0, below that the plain attention that
the JAX package computes outside any kernel, on every device.

The kernels read q, k and v in place when the three share their strides and
the last axis is contiguous (the views of one ``[B, T, 3, H, D]`` projection
do); otherwise they are made contiguous once. The backward writes dq, dk and
dv into the three slices of one ``[B, T, 3, H, D]`` buffer, so the gradient of
that projection is assembled without a copy per slice.

The plain versions are the JAX package's XLA branch (probabilities rounded to
the input dtype, P V accumulated in fp32) and a hand-written backward with the
kernels' formulas: P recomputed from the saved log-sum-exp, delta =
rowsum(dO * O), dS = P * (dP - delta), dS and P rounded to the input dtype
where the kernels feed them to the next product.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from rectified_flow_vision_tpu_torch.ops import build

Tensor = torch.Tensor

FLASH_MIN_SEQ = 1024  # the JAX package's _FLASH_MIN_SEQ
FLASH_SEQ_MULTIPLE = 128  # its smallest valid block (_flash_block_sizes)
KERNEL_TILE = 128  # the kernels take T in multiples of their 128-row blocks
HEAD_DIM_MIN, HEAD_DIM_MAX = 8, 128  # D a multiple of 8 in this range


def use_flash(t: int) -> bool:
    """Whether a sequence of ``t`` tokens takes the flash kernel."""
    return t >= FLASH_MIN_SEQ and t % FLASH_SEQ_MULTIPLE == 0


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head width the kernels are compiled for that takes D = ``d``:
    bf16 64 (d <= 64) or 128, fp32 ``d`` rounded up to a multiple of 16.
    Raises for a width the kernels do not take."""
    if d % 8 or not HEAD_DIM_MIN <= d <= HEAD_DIM_MAX:
        raise ValueError(
            f"head dimension {d} not supported: the flash kernels take D a multiple of 8 "
            f"from {HEAD_DIM_MIN} to {HEAD_DIM_MAX} (DiT-S, B and L give 64, XL 72)"
        )
    if dtype == torch.bfloat16:
        return 64 if d <= 64 else 128
    return -(-d // 16) * 16


def _logits(q: Tensor, k: Tensor) -> Tensor:
    """fp32 logits [B, H, T, S] of [B, T, H, D] q and [B, S, H, D] k, scaled."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) * scale


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """softmax(q k^T / sqrt(D)) v over [B, T, H, D] in plain PyTorch: fp32
    logits and softmax, probabilities rounded to q's dtype, P V accumulated in
    fp32, one rounding of the result."""
    attn = torch.softmax(_logits(q, k), dim=-1).to(q.dtype)
    out = torch.matmul(attn.float(), v.float().transpose(1, 2))  # [B, H, T, D]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_lse_plain(q: Tensor, k: Tensor) -> Tensor:
    """The per-row log-sum-exp of the scaled logits, fp32 [B, H, T]."""
    return torch.logsumexp(_logits(q, k), dim=-1)


def flash_attention_backward_plain(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, d_out: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) by the backward kernels' formulas, in plain PyTorch.

    ``out`` and ``lse`` are the forward's output and log-sum-exp; products
    accumulate in fp32, and P and dS are rounded to q's dtype before the
    products that consume them, as the bf16 kernels must.
    """
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_logits(q, k) - lse[..., None])  # [B, H, T, S]
    go = d_out.float().transpose(1, 2)  # [B, H, T, D]
    delta = (go * out.float().transpose(1, 2)).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), go)  # [B, H, S, D]
    dp = torch.matmul(go, v.float().permute(0, 2, 3, 1))
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, k.float().transpose(1, 2)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float().transpose(1, 2)) * scale
    return tuple(g.transpose(1, 2).to(dt) for g in (dq, dk, dv))


def _check(q: Tensor, k: Tensor, v: Tensor, kernel: str) -> Tuple[int, int, int, int, int]:
    build.require_cuda(q, kernel)
    if q.ndim != 4:
        raise ValueError(f"{kernel}: q must be [B, T, H, D], got {tuple(q.shape)}")
    b, t, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{kernel}: {name} is {tuple(x.shape)} {x.dtype} on {x.device}, expected "
                f"{tuple(q.shape)} {q.dtype} on {q.device} (self-attention, as DiT calls it)"
            )
    try:
        dp = kernel_head_dim(d, q.dtype)
    except ValueError as err:
        raise ValueError(f"{kernel}: {err}") from None
    if t % KERNEL_TILE or t == 0:
        raise ValueError(f"{kernel}: {t} tokens is not a multiple of the {KERNEL_TILE}-row tile")
    if b > 65535 or h > 65535 or b == 0:
        raise ValueError(f"{kernel}: batch {b} or heads {h} outside the launch grid")
    return b, t, h, d, dp


def _shared_strides(q: Tensor, k: Tensor, v: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """q, k, v as the kernels read them: one set of strides, a contiguous
    last axis, 16-byte aligned rows, and heads, tokens and batches nested in
    that order (the kernels' tensor maps view them as (D, H, T, B)). Copies
    only what does not comply."""
    vec = 16 // q.element_size()
    b, t, h, d = q.shape
    sb, st, sh, sd = q.stride()
    ok = (
        q.stride() == k.stride() == v.stride()
        and sd == 1
        and all(s % vec == 0 for s in (sb, st, sh))
        and sh >= d and st >= h * sh and sb >= t * st
        and all(x.data_ptr() % 16 == 0 for x in (q, k, v))
    )
    if ok:
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch the forward kernel: (out [B, T, H, D] contiguous in q's dtype,
    lse [B, H, T] fp32)."""
    b, t, h, d, dp = _check(q, k, v, "flash_attention")
    q, k, v = _shared_strides(q, k, v)
    out = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    sb, st, sh, _ = q.stride()
    rc = build.library().rfv_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, t, h, d, dp, sb, st, sh, 1.0 / math.sqrt(d), build.DTYPE_CODES[q.dtype],
        build.stream_ptr(q),
    )
    build.check(rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_backward_cuda(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, d_out: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the backward kernels (delta, dkv, dq): (dq, dk, dv), the three
    slices of one new [B, T, 3, H, D] buffer."""
    b, t, h, d, dp = _check(q, k, v, "flash_attention_backward")
    q, k, v = _shared_strides(q, k, v)
    build.require(out, "out", device=q.device, dtype=q.dtype, shape=(b, t, h, d))
    build.require(lse, "lse", device=q.device, dtype=torch.float32, shape=(b, h, t))
    d_out = d_out.contiguous()
    build.require(d_out, "d_out", device=q.device, dtype=q.dtype, shape=(b, t, h, d))
    grads = torch.empty((b, t, 3, h, d), device=q.device, dtype=q.dtype)
    dq, dk, dv = grads.unbind(2)
    delta = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    sb, st, sh, _ = q.stride()
    gb, gt, gh, _ = dq.stride()
    rc = build.library().rfv_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, h, d, dp, sb, st, sh, gb, gt, gh, 1.0 / math.sqrt(d), build.DTYPE_CODES[q.dtype],
        build.stream_ptr(q),
    )
    build.check(rc, "flash_attention_backward")
    build.LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv

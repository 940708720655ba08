"""Flash attention, forward and backward: CUDA kernels and their plain versions.

Replaces the Pallas TPU library kernel that the JAX package's DiT calls
(``rectified_flow_vision_tpu/models/dit.py`` ``_attention`` ->
``pallas.ops.tpu.flash_attention`` with its dq and dkv backward kernels):
non-causal multi-head attention over q, k, v ``[B, T, H, D]``, scale
1/sqrt(D), fp32 softmax. Bound by operations on the H100
(``csrc/flash_attention.cu``); nothing of size T^2 reaches device memory.

Head widths: every D >= 1, as the JAX ``_attention``. A D % 8 == 0 is read
in place (DiT-S, B and L give 64, XL 72). Any other D is zero-padded in the
head axis, in one copy of q, k and v, to the next multiple of 8
(``padded_head_dim``; a TMA box cannot hold a bf16 row of 24 bytes), and the
kernels run at scale 1/sqrt(D) of the true D: zero columns add nothing to
Q K^T, dP or delta and give zero output columns, which are sliced off.
``kernel_head_dim`` gives the width the kernels are compiled for. The bf16
kernels (``wgmma`` + TMA) read q, k and v in place at every width: up to
D = 256 (``HEAD_DIM_WIDE``) they pad it in shared memory to 64, 128, 192 or
256 (one to four 128-byte TMA boxes, columns past D zero-filled) and above 128
stream 64-key tiles and split dkv and dq between their warpgroups; above 256
the streamed kernels (``csrc/flash_attention_streamed.cu``) sum the logits
over D one 64-column box at a time and write the outputs in chunks of 192 or
256 columns. The fp32 kernels take D up to 128 (``HEAD_DIM_MAX_F32``) at
D itself (3xTF32 products on the tensor cores, compiled at every multiple of
8: DiT-XL's 72 runs at 72); wider fp32 heads take the *_wide fp32 kernels,
whose blocks own every output column of their rows up to D = 256 (O and dQ
up to 384; the fewest chunks above it), so that each logit is computed once
for each output block. Above 128 (fp32) and 256 (bf16) the width is a
multiple of 64 (``HEAD_DIM_BOX``).

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
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rectified_flow_vision_tpu_torch.ops import build

Tensor = torch.Tensor

FLASH_MIN_SEQ = 1024  # the JAX package's _FLASH_MIN_SEQ
FLASH_SEQ_MULTIPLE = 128  # its smallest valid block (_flash_block_sizes)
KERNEL_TILE = 128  # the kernels take T in multiples of their 128-row blocks
HEAD_DIM_WIDE = 256  # the widest bf16 head held whole by a warpgroup; wider: streamed
HEAD_DIM_MAX_F32 = 128  # the widest head of the fp32 kernels; wider: the *_wide fp32 kernels
HEAD_DIM_BOX = 64  # above those two widths, the kernels' widths are multiples of this


def use_flash(t: int) -> bool:
    """Whether a sequence of ``t`` tokens takes the flash kernel."""
    return t >= FLASH_MIN_SEQ and t % FLASH_SEQ_MULTIPLE == 0


def padded_head_dim(d: int) -> int:
    """The width q, k and v reach the kernels at: D itself where it is a
    multiple of 8 (16-byte rows), else D zero-padded to the next one."""
    if d < 1:
        raise ValueError(f"head dimension {d} not supported: the flash kernels take D >= 1")
    return -(-d // 8) * 8


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head width the kernels are compiled for that takes D = ``d``
    (after ``padded_head_dim``): fp32 the padded width itself up to 128 (a
    multiple of 8), otherwise the next multiple of 64 (bf16: 64, 128, 192 or
    256, and above 256 the streamed kernels; fp32 above 128 the *_wide
    kernels). Raises only for d < 1."""
    dk = padded_head_dim(d)
    if dtype == torch.bfloat16 or dk > HEAD_DIM_MAX_F32:
        return -(-dk // HEAD_DIM_BOX) * HEAD_DIM_BOX
    return dk


def _scale(q: Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _logits(q: Tensor, k: Tensor, scale: Optional[float] = None) -> Tensor:
    """fp32 logits [B, H, T, S] of [B, T, H, D] q and [B, S, H, D] k, scaled."""
    return torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) * _scale(q, scale)


def flash_attention_plain(
    q: Tensor, k: Tensor, v: Tensor, *, scale: Optional[float] = None
) -> Tensor:
    """softmax(q k^T * scale) v over [B, T, H, D] in plain PyTorch (scale
    1/sqrt(D) unless given): fp32 logits and softmax, probabilities rounded to
    q's dtype, P V accumulated in fp32, one rounding of the result."""
    attn = torch.softmax(_logits(q, k, scale), dim=-1).to(q.dtype)
    out = torch.matmul(attn.float(), v.float().transpose(1, 2))  # [B, H, T, D]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_lse_plain(q: Tensor, k: Tensor, *, scale: Optional[float] = None) -> Tensor:
    """The per-row log-sum-exp of the scaled logits, fp32 [B, H, T]."""
    return torch.logsumexp(_logits(q, k, scale), dim=-1)


def flash_attention_backward_plain(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, d_out: Tensor,
    *, scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) by the backward kernels' formulas, in plain PyTorch.

    ``out`` and ``lse`` are the forward's output and log-sum-exp; products
    accumulate in fp32, and P and dS are rounded to q's dtype before the
    products that consume them, as the bf16 kernels must.
    """
    dt = q.dtype
    scale = _scale(q, scale)
    p = torch.exp(_logits(q, k, scale) - lse[..., None])  # [B, H, T, S]
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


def _widen(ts: Sequence[Tensor], dk: int) -> Tuple[Tensor, ...]:
    """[B, T, H, D] tensors as the slices of one zero-padded [B, T, n, H, dk]
    buffer (one copy each)."""
    b, t, h, d = ts[0].shape
    buf = torch.zeros((b, t, len(ts), h, dk), device=ts[0].device, dtype=ts[0].dtype)
    for i, x in enumerate(ts):
        buf[:, :, i, :, :d] = x
    return buf.unbind(2)


def _kernel_inputs(q, k, v, d: int) -> Tuple[Tensor, Tensor, Tensor]:
    """q, k, v as the kernels take them, in their own dtype at every width:
    in place where D is a multiple of 8, else one zero-padded copy."""
    dk = padded_head_dim(d)
    if dk == d:
        return _shared_strides(q, k, v)
    return _widen((q, k, v), dk)


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch the forward kernel: (out [B, T, H, D] contiguous in q's dtype,
    lse [B, H, T] fp32)."""
    b, t, h, d, dp = _check(q, k, v, "flash_attention")
    q, k, v = _kernel_inputs(q, k, v, d)
    dk = q.shape[-1]
    out = torch.empty((b, t, h, dk), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    sb, st, sh, _ = q.stride()
    rc = build.library().rfv_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, t, h, dk, dp, sb, st, sh, 1.0 / math.sqrt(d), build.DTYPE_CODES[q.dtype],
        build.stream_ptr(q),
    )
    build.check(rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    if dk != d:
        out = out[..., :d].contiguous()
    return out, lse


def flash_attention_backward_cuda(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, d_out: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the backward kernels (delta, dkv, dq): (dq, dk, dv), the three
    slices of one new [B, T, 3, H, D] buffer."""
    b, t, h, d, dp = _check(q, k, v, "flash_attention_backward")
    dtype = q.dtype
    build.require(out, "out", device=q.device, dtype=dtype, shape=(b, t, h, d))
    build.require(lse, "lse", device=q.device, dtype=torch.float32, shape=(b, h, t))
    d_out = d_out.contiguous()
    build.require(d_out, "d_out", device=q.device, dtype=dtype, shape=(b, t, h, d))
    q, k, v = _kernel_inputs(q, k, v, d)
    dk = q.shape[-1]
    if dk != d:  # contiguous [B, T, H, dk] each
        out, d_out = (F.pad(x, (0, dk - d)) for x in (out, d_out))
    grads = torch.empty((b, t, 3, h, dk), device=q.device, dtype=q.dtype)
    g_q, g_k, g_v = grads.unbind(2)
    delta = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    sb, st, sh, _ = q.stride()
    gb, gt, gh, _ = g_q.stride()
    rc = build.library().rfv_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), g_q.data_ptr(), g_k.data_ptr(), g_v.data_ptr(),
        b, t, h, dk, dp, sb, st, sh, gb, gt, gh, 1.0 / math.sqrt(d), build.DTYPE_CODES[q.dtype],
        build.stream_ptr(q),
    )
    build.check(rc, "flash_attention_backward")
    build.LAUNCHES["flash_attention_backward"] += 1
    if dk != d:
        grads = grads[..., :d].contiguous()
    return grads.unbind(2)

"""QK-RMSNorm + rotary position embedding of a joint attention: a CUDA kernel
and its plain version.

Replaces no Pallas TPU kernel: the JAX package has no text-conditioned
transformer. FLUX's blocks (``models/flux.py``) normalise each head of q and
k by its RMS in fp32, scale it by a learned vector of the head width, rotate
adjacent pairs (2j, 2j + 1) by the angles of the token's position, and
attend over the text tokens followed by the image tokens. Left eager, that is
a dozen passes over q and k and a ``cat`` of q, k and v per block; the
kernel (``csrc/qk_norm_rope.cu``) reads a stream's qkv projection once and
writes q, k and v into their rows of one joint ``[B, T, 3, H, D]`` buffer,
whose three slices flash attention reads in place:

    qk_norm_rope(qkv, q_scale, k_scale, cos, sin, out, off)
        out[:, off:off + T_s] = (rope(rms(q) * q_scale), rope(rms(k) * k_scale), v)

``qkv`` is one stream's ``[B, T_s, 3C]`` projection (its bias added), C = H
x D; ``q_scale`` and ``k_scale`` are fp32 ``[D]``; ``cos`` and ``sin`` are
fp32 ``[T, D / 2]`` tables of the joint sequence's angles, row ``off + t``
for the stream's token t. A text token sits at position 0, so its row holds
cos 1 and sin 0 and it is left as normalised. Arithmetic: fp32 throughout,
``x * rsqrt(mean(x^2) + eps) * scale`` and then (c a - s b, s a + c b) for a
pair (a, b), one rounding to the output dtype at the end; v is copied. The
kernel keeps those rounding points; it differs from the plain version only by
the order of its fp32 sum of squares and by ``rsqrtf``. Bound by bytes on the
H100. No kernel has a backward: ``ops/fused.py`` differentiates the plain
version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from rectified_flow_vision_tpu_torch.ops import build

Tensor = torch.Tensor

EPS = 1e-6
MAX_LANES = 32  # a head's 16-byte vectors share one warp's shuffles


def supports(c: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes heads of ``d`` channels in rows of ``c``:
    a head a power of two of 16-byte vectors, at most a warp's 32, and a
    row of at most 1024 vectors (one thread each)."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    lanes = d // vec
    return (d % vec == 0 and c % d == 0 and 1 <= lanes <= MAX_LANES
            and lanes & (lanes - 1) == 0 and c // vec <= 1024)


def qk_norm_rope_plain(qkv: Tensor, q_scale: Tensor, k_scale: Tensor, cos: Tensor, sin: Tensor,
                       heads: int, eps: float = EPS) -> Tensor:
    """One stream's ``[B, T_s, 3C]`` projection as ``[B, T_s, 3, H, D]``: q
    and k RMS-normalised and scaled in fp32, rotated by ``cos`` / ``sin``
    (``[T_s, D / 2]``, the stream's rows), rounded once; v as it is."""
    b, t, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, v = qkv.reshape(b, t, 3, heads, d).unbind(2)
    c, s = cos[None, :, None, :], sin[None, :, None, :]

    def norm_rope(x: Tensor, scale: Tensor) -> Tensor:
        xf = x.float()
        n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * scale.float()
        a, bb = n[..., 0::2], n[..., 1::2]
        return torch.stack((c * a - s * bb, s * a + c * bb), dim=-1).flatten(-2).to(x.dtype)

    return torch.stack((norm_rope(q, q_scale), norm_rope(k, k_scale), v), dim=2)


def joint_plain(streams: Sequence[Tuple[Tensor, Tensor, Tensor]], cos: Tensor, sin: Tensor,
                heads: int) -> Tensor:
    """The joint ``[B, T, 3, H, D]`` of the streams (``(qkv, q_scale,
    k_scale)`` each, in token order): each stream's plain version on its rows
    of the tables, concatenated along the tokens."""
    parts, off = [], 0
    for qkv, qs, ks in streams:
        t = qkv.shape[1]
        parts.append(qk_norm_rope_plain(qkv, qs, ks, cos[off:off + t], sin[off:off + t], heads))
        off += t
    return torch.cat(parts, dim=1)


def _vector(kernel: str, name: str, x: Tensor, n: int, device: torch.device) -> Tensor:
    if x.dtype != torch.float32 or x.device != device or x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"{kernel}: {name} must be float32 [{n}] on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x if x.is_contiguous() and x.data_ptr() % 16 == 0 else x.contiguous()


def qk_norm_rope_cuda(qkv: Tensor, q_scale: Tensor, k_scale: Tensor, cos: Tensor, sin: Tensor,
                      out: Tensor, off: int, eps: float = EPS) -> None:
    """Launch ``qk_norm_rope`` for one stream, writing rows ``off:off + T_s``
    of ``out``. qkv: ``[B, T_s, 3C]`` bf16 or fp32, contiguous; out: ``[B,
    T, 3, H, D]`` of its dtype, contiguous, T >= off + T_s; q_scale, k_scale:
    fp32 ``[D]``; cos, sin: fp32 ``[T, D / 2]``, contiguous."""
    kernel = "qk_norm_rope"
    build.require_cuda(qkv, kernel)
    if out.ndim != 5 or qkv.ndim != 3:
        raise ValueError(f"{kernel}: qkv must be [B, T, 3C] and out [B, T, 3, H, D], got "
                         f"{tuple(qkv.shape)} and {tuple(out.shape)}")
    b, t_out, _, h, d = out.shape
    c = h * d
    t = qkv.shape[1]
    build.require(qkv, "qkv", device=out.device, dtype=out.dtype, shape=(b, t, 3 * c))
    build.require(out, "out", device=qkv.device, dtype=qkv.dtype, shape=out.shape)
    if not supports(c, d, qkv.dtype):
        raise ValueError(f"{kernel}: heads of {d} in rows of {c} {qkv.dtype} channels are not "
                         "a power of two of 16-byte vectors up to 32, in at most 1024 vectors")
    if off < 0 or off + t > t_out:
        raise ValueError(f"{kernel}: rows {off}:{off + t} outside the {t_out} of out")
    q_scale = _vector(kernel, "q_scale", q_scale, d, qkv.device)
    k_scale = _vector(kernel, "k_scale", k_scale, d, qkv.device)
    for name, tab in (("cos", cos), ("sin", sin)):
        build.require(tab, name, device=qkv.device, dtype=torch.float32, shape=(t_out, d // 2))
    if any(x.data_ptr() % 16 for x in (qkv, out, cos, sin)):
        raise ValueError(f"{kernel}: qkv, out and the tables must be 16-byte aligned")
    if b * t == 0:
        return
    rc = build.library().rfv_qk_norm_rope(
        qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        out.data_ptr(), b * t, t, t_out, off, c, d, float(eps), build.DTYPE_CODES[qkv.dtype],
        build.stream_ptr(qkv),
    )
    build.check(rc, kernel)
    build.LAUNCHES[kernel] += 1


def joint_cuda(streams: Sequence[Tuple[Tensor, Tensor, Tensor]], cos: Tensor, sin: Tensor,
               heads: int) -> Tensor:
    """``joint_plain`` on the card: one launch a stream into one new buffer."""
    first = streams[0][0]
    b, _, c3 = first.shape
    t = sum(qkv.shape[1] for qkv, _, _ in streams)
    out = torch.empty((b, t, 3, heads, c3 // 3 // heads), device=first.device, dtype=first.dtype)
    off = 0
    for qkv, qs, ks in streams:
        qk_norm_rope_cuda(qkv, qs, ks, cos, sin, out, off)
        off += qkv.shape[1]
    return out

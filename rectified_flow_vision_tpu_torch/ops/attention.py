"""UNet spatial self-attention block: CUDA kernels and their plain version.

Replaces the Pallas TPU kernel ``rectified_flow_vision_tpu/ops/pallas_kernels.py``
``attention_block`` (``_attention_kernel``): GroupNorm -> qkv (C -> 3C) ->
multi-head softmax(QK^T / sqrt(d)) V with an fp32 softmax -> proj -> +x.
Bound on the H100: operations (51.5 GFLOP at the flagship's (256, 16, 16,
256), 0.052 ms at 989 TFLOP/s). One image's qkv does not fit a block's
shared memory, so ``csrc/attention.cu`` is four launches over all B*N rows:
GroupNorm (gn_silu's one-pass cluster kernel without the SiLU),
the qkv projection on the conv's ``wgmma`` + TMA kernel as a one-tap conv, a
flash-style key loop on the tensor cores (online fp32 softmax, q, k, v read
in place from qkv, nothing of size N^2 stored, so any number of tokens), and
the proj projection on the same ``wgmma`` kernel with the residual in its
epilogue. fp32 runs the same steps on fp32 FMAs.

Weights take torch Linear layouts: ``w_qkv`` (3Ci, C), ``w_proj`` (C, Ci),
in x's dtype; norm parameters and biases are fp32. Ci is C, or under tensor
parallelism the width of the rank's heads (``num_heads`` of them); then
``residual=False`` returns the projection alone, the rank's partial sum.
"""

from __future__ import annotations

import torch

from typing import Optional

from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
from rectified_flow_vision_tpu_torch.ops import primitives as P

Tensor = torch.Tensor


def attention_block_plain(
    x: Tensor,
    norm_scale: Tensor,
    norm_bias: Tensor,
    w_qkv: Tensor,
    b_qkv: Tensor,
    w_proj: Tensor,
    b_proj: Tensor,
    *,
    num_heads: int = 4,
    num_groups: int = 8,
    residual: bool = True,
) -> Tensor:
    """Plain PyTorch version (``P.spatial_attention``)."""
    return P.spatial_attention(
        x, norm_scale, norm_bias, w_qkv, b_qkv, w_proj, b_proj,
        num_heads=num_heads, num_groups=num_groups, residual=residual,
    )


def supports(
    c: int, num_heads: int, num_groups: int, dtype: torch.dtype, ci: Optional[int] = None
) -> bool:
    """The kernels' contract for C channels and heads of width Ci (default
    C): C a multiple of the groups (at most 32), Ci of the heads, head width
    at most 128, C / V <= 256 for the GroupNorm passes (V the widest vector
    of at most 16 bytes whose element count divides C / groups), and for bf16
    C % 8 == Ci % 8 == 0 (16-byte rows for TMA). Any number of tokens."""
    ci = c if ci is None else ci
    if num_groups < 1 or num_heads < 1 or c % num_groups or ci % num_heads:
        return False
    if num_groups > 32 or ci // num_heads > 128:
        return False
    if dtype == torch.bfloat16 and (c % 8 or ci % 8):
        return False
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    while (c // num_groups) % vec:
        vec //= 2
    return c // vec <= 256


def attention_block_cuda(
    x: Tensor,
    norm_scale: Tensor,
    norm_bias: Tensor,
    w_qkv: Tensor,
    b_qkv: Tensor,
    w_proj: Tensor,
    b_proj: Tensor,
    *,
    num_heads: int = 4,
    num_groups: int = 8,
    residual: bool = True,
) -> Tensor:
    """Launch the CUDA kernels. x: (B, H, W, C) bf16/fp32; GroupNorm eps is
    1e-5, as in ``P.group_norm``."""
    build.require_cuda(x, "attention_block")
    b, h, w, c = x.shape
    n = h * w
    ci = w_qkv.shape[0] // 3
    dev, dt, f32 = x.device, x.dtype, torch.float32
    if not supports(c, num_heads, num_groups, dt, ci):
        raise ValueError(
            f"attention_block: x {tuple(x.shape)} with {num_heads} heads of width {ci}, "
            f"{num_groups} groups not supported (needs C % groups == 0, groups <= 32, "
            "Ci % heads == 0, Ci / heads <= 128, bf16 C % 8 == Ci % 8 == 0)"
        )
    if b * n * 3 * max(c, ci) >= 2**31:
        raise ValueError(f"attention_block: x {tuple(x.shape)} too large for 32-bit indices")
    build.require(x, "x", device=dev, dtype=dt, shape=x.shape)
    build.require(norm_scale, "norm_scale", device=dev, dtype=f32, shape=(c,))
    build.require(norm_bias, "norm_bias", device=dev, dtype=f32, shape=(c,))
    build.require(w_qkv, "w_qkv", device=dev, dtype=dt, shape=(3 * ci, c))
    build.require(b_qkv, "b_qkv", device=dev, dtype=f32, shape=(3 * ci,))
    build.require(w_proj, "w_proj", device=dev, dtype=dt, shape=(c, ci))
    build.require(b_proj, "b_proj", device=dev, dtype=f32, shape=(c,))
    lib = build.library()
    qkv = torch.empty((b, n, 3 * ci), device=dev, dtype=dt)
    att = torch.empty((b, n, max(c, ci)), device=dev, dtype=dt)
    out = torch.empty_like(x)
    # bf16: the two projections' tiling on the conv's wgmma kernel (one tap)
    t_qkv, t_proj = C.tile_config(h, w, c, 3 * ci), C.tile_config(h, w, ci, c)
    rc = lib.rfv_attention_block(
        x.data_ptr(), norm_scale.data_ptr(), norm_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(),
        qkv.data_ptr(), att.data_ptr(), out.data_ptr(),
        b, h, w, c, ci, num_heads, num_groups, 1e-5, int(residual),
        t_qkv["bn"], t_qkv["stages"], t_qkv["hb"], t_proj["bn"], t_proj["stages"], t_proj["hb"],
        t_qkv["wb"],
        build.DTYPE_CODES[dt], build.stream_ptr(x),
    )
    build.check(rc, "attention_block")
    build.LAUNCHES["attention_block"] += 1
    return out

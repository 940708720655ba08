"""UNet spatial self-attention block: CUDA kernels and their plain version.

Replaces the Pallas TPU kernel ``rectified_flow_vision_tpu/ops/pallas_kernels.py``
``attention_block`` (``_attention_kernel``): GroupNorm -> qkv (C -> 3C) ->
multi-head softmax(QK^T / sqrt(d)) V with an fp32 softmax -> proj -> +x.
On the H100 it is three launches (``csrc/attention.cu``): GroupNorm + qkv,
attention per (image, head, 32 query rows), proj + bias + residual; one
image's qkv does not fit a block's shared memory. Operations bound it on
paper; all products run on fp32 FMAs for now (design notes in the source).

Weights take torch Linear layouts: ``w_qkv`` (3C, C), ``w_proj`` (C, C), in
x's dtype; norm parameters and biases are fp32.
"""

from __future__ import annotations

import torch

from rectified_flow_vision_tpu_torch.ops import build
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
) -> Tensor:
    """Plain PyTorch version (``P.spatial_attention``)."""
    return P.spatial_attention(
        x, norm_scale, norm_bias, w_qkv, b_qkv, w_proj, b_proj,
        num_heads=num_heads, num_groups=num_groups,
    )


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
) -> Tensor:
    """Launch the three CUDA kernels. x: (B, H, W, C) bf16/fp32; GroupNorm
    eps is 1e-5, as in ``P.group_norm``."""
    build.require_cuda(x, "attention_block")
    b, h, w, c = x.shape
    n = h * w
    dev, dt, f32 = x.device, x.dtype, torch.float32
    lib = build.library()
    ok = n <= 256 and c % num_groups == 0 and num_groups <= 32 and c % num_heads == 0
    if not ok or lib.rfv_attention_core_smem(n, c // num_heads, build.DTYPE_CODES[dt]) > 232448:
        raise ValueError(
            f"attention_block: x {tuple(x.shape)} with {num_heads} heads, {num_groups} "
            "groups not supported (needs H*W <= 256 tokens, C % groups == 0, "
            "C % heads == 0, and one head's K, V in 227 KB of shared memory)"
        )
    build.require(x, "x", device=dev, dtype=dt, shape=x.shape)
    build.require(norm_scale, "norm_scale", device=dev, dtype=f32, shape=(c,))
    build.require(norm_bias, "norm_bias", device=dev, dtype=f32, shape=(c,))
    build.require(w_qkv, "w_qkv", device=dev, dtype=dt, shape=(3 * c, c))
    build.require(b_qkv, "b_qkv", device=dev, dtype=f32, shape=(3 * c,))
    build.require(w_proj, "w_proj", device=dev, dtype=dt, shape=(c, c))
    build.require(b_proj, "b_proj", device=dev, dtype=f32, shape=(c,))
    qkv = torch.empty((b, n, 3 * c), device=dev, dtype=dt)
    att = torch.empty((b, n, c), device=dev, dtype=dt)
    out = torch.empty_like(x)
    rc = lib.rfv_attention_block(
        x.data_ptr(), norm_scale.data_ptr(), norm_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(),
        qkv.data_ptr(), att.data_ptr(), out.data_ptr(),
        b, n, c, num_heads, num_groups, 1e-5, build.DTYPE_CODES[dt], build.stream_ptr(x),
    )
    build.check(rc, "attention_block")
    build.LAUNCHES["attention_block"] += 1
    return out


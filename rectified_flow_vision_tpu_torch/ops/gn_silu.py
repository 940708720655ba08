"""Fused GroupNorm + SiLU over NHWC: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``rectified_flow_vision_tpu/ops/pallas_kernels.py``
``gn_silu`` (``_gn_silu_kernel``, ``_group_stats``). The kernel
(``csrc/gn_silu.cu``) is bound by bytes on the H100: one read of x for the
group statistics, one read and one write for the normalise/affine/SiLU pass
(the second read is often served by L2). Its design notes are in the source.

``ops/fused.py`` dispatches: a CPU tensor takes the plain version, a CUDA
tensor the kernel.
"""

from __future__ import annotations

import torch

from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import primitives as P

Tensor = torch.Tensor


def gn_silu_plain(
    x: Tensor, scale: Tensor, bias: Tensor, *, num_groups: int = 8, eps: float = 1e-5
) -> Tensor:
    """silu(group_norm(x)) in plain PyTorch, rounding where the JAX XLA path does."""
    return P.silu(P.group_norm(x, scale, bias, num_groups=num_groups, eps=eps))


def check_channels(kernel: str, x: Tensor, num_groups: int) -> None:
    """Raise unless the GroupNorm kernels take x's channel count."""
    c = x.shape[-1]
    # the kernel's vector: the widest (<= 16 bytes) that divides a group
    vec = 16 // x.element_size()
    while c % num_groups == 0 and (c // num_groups) % vec:
        vec //= 2
    if c % num_groups or c // vec > 256 or num_groups > 32:
        raise ValueError(
            f"{kernel}: C={c} with {num_groups} groups is not supported (needs "
            f"C % groups == 0, C / {vec} <= 256, groups <= 32)"
        )


def gn_silu_cuda(
    x: Tensor, scale: Tensor, bias: Tensor, *, num_groups: int = 8, eps: float = 1e-5
) -> Tensor:
    """Launch the CUDA kernel. x: (B, H, W, C) bf16/fp32; scale, bias: (C,) fp32."""
    build.require_cuda(x, "gn_silu")
    b, h, w, c = x.shape
    check_channels("gn_silu", x, num_groups)
    build.require(x, "x", device=x.device, dtype=x.dtype, shape=x.shape)
    for name, t in (("scale", scale), ("bias", bias)):
        build.require(t, name, device=x.device, dtype=torch.float32, shape=(c,))
    lib = build.library()
    n_part = lib.rfv_gn_silu_workspace(b, h * w, num_groups)
    part = torch.empty((n_part, 2), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    rc = lib.rfv_gn_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(), out.data_ptr(),
        b, h * w, c, num_groups, eps, build.DTYPE_CODES[x.dtype], build.stream_ptr(x),
    )
    build.check(rc, "gn_silu")
    build.LAUNCHES["gn_silu"] += 1
    return out


"""Fused GroupNorm + SiLU over NHWC, forward and backward: CUDA kernels and
their plain versions.

Replaces the Pallas TPU kernel ``rectified_flow_vision_tpu/ops/pallas_kernels.py``
``gn_silu`` (``_gn_silu_kernel``, ``_group_stats``) and the fused XLA VJP the
JAX package takes for its backward (``ops/fused.py`` ``_gn_silu_bwd``). Both
kernels (``csrc/gn_silu.cu``) are bound by bytes on the H100 and move each
byte once: the forward reads x and writes y, the backward reads x and the
cotangent and writes dx. One thread-block cluster holds an image's slab in
shared memory; a forward slab too large for one cluster (the ConvVAE's)
takes the streamed plan, the image spread over the whole card with its
statistics merged through device memory. The design notes are in the
source.

The forward saves each (image, group)'s mean and 1/sigma, fp32 ``[B, G, 2]``
(``gn_stats_plain``), for the backward, whose formulas
``gn_silu_backward_plain`` writes out in plain PyTorch.

``ops/fused.py`` dispatches: a CPU tensor takes the plain version, a CUDA
tensor the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import primitives as P

Tensor = torch.Tensor


def gn_silu_plain(
    x: Tensor, scale: Tensor, bias: Tensor, *, num_groups: int = 8, eps: float = 1e-5
) -> Tensor:
    """silu(group_norm(x)) in plain PyTorch, rounding where the JAX XLA path does."""
    return P.silu(P.group_norm(x, scale, bias, num_groups=num_groups, eps=eps))


def gn_stats_plain(x: Tensor, *, num_groups: int = 8, eps: float = 1e-5) -> Tensor:
    """Each (image, group)'s fp32 mean and 1/sqrt(var + eps), ``[B, G, 2]``:
    what the forward kernels save for the backward (two-pass, as
    ``P.group_norm``)."""
    b = x.shape[0]
    xg = x.float().reshape(b, -1, num_groups, x.shape[-1] // num_groups)
    mean = xg.mean(dim=(1, 3))
    var = (xg - mean[:, None, :, None]).square().mean(dim=(1, 3))
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=-1)


def gn_silu_backward_plain(
    x: Tensor, g: Tensor, scale: Tensor, bias: Tensor, stats: Tensor, *, num_groups: int = 8
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dx, dscale, dbias) of ``gn_silu`` by the backward kernel's formulas,
    in fp32 from the saved statistics; dx rounded once to x's dtype. ``g`` is
    the cotangent (for the dropout variant: already times mask / keep)::

        z = scale * xhat + bias,  xhat = (x - mean) / sigma
        dz = g * s * (1 + z * (1 - s)),  s = sigmoid(z)
        dbias = sum dz,  dscale = sum dz * xhat       (over images and pixels)
        a = mean_group(dz * scale),  c = mean_group(dz * scale * xhat)
        dx = (dz' * scale - a - xhat * c) / sigma

    The sums take dz in fp32; dx takes dz', dz rounded to x's dtype, as the
    kernel keeps it between its two passes over the image.
    """
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    mean = stats[..., 0].repeat_interleave(cg, dim=1)[:, None, None, :]  # [B, 1, 1, C]
    rstd = stats[..., 1].repeat_interleave(cg, dim=1)[:, None, None, :]
    xh = (x.float() - mean) * rstd
    z = xh * scale.float() + bias.float()
    s = torch.sigmoid(z)
    dz = g.float() * s * (1.0 + z * (1.0 - s))
    dbias = dz.sum(dim=(0, 1, 2))
    dscale = (dz * xh).sum(dim=(0, 1, 2))
    dzs = (dz * scale.float()).reshape(b, -1, num_groups, cg)
    xhg = xh.reshape(b, -1, num_groups, cg)
    a = dzs.mean(dim=(1, 3), keepdim=True)
    cc = (dzs * xhg).mean(dim=(1, 3), keepdim=True)
    kept = (dz.to(x.dtype).float() * scale.float()).reshape(b, -1, num_groups, cg)
    dx = (kept - a - xhg * cc).reshape(x.shape) * rstd
    return dx.to(x.dtype), dscale, dbias


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


def check_args(kernel: str, x: Tensor, scale: Tensor, bias: Tensor, num_groups: int) -> None:
    """Device, dtype, shape and contiguity of a GroupNorm kernel's inputs."""
    build.require_cuda(x, kernel)
    check_channels(kernel, x, num_groups)
    if x.ndim != 4 or x.shape[0] > 65535 or x.numel() == 0:
        raise ValueError(f"{kernel}: x must be a non-empty (B <= 65535, H, W, C) tensor")
    build.require(x, "x", device=x.device, dtype=x.dtype, shape=x.shape)
    for name, t in (("scale", scale), ("bias", bias)):
        build.require(t, name, device=x.device, dtype=torch.float32, shape=(x.shape[-1],))


def gn_silu_cuda(
    x: Tensor, scale: Tensor, bias: Tensor, *, num_groups: int = 8, eps: float = 1e-5,
) -> Tuple[Tensor, Tensor]:
    """Launch the forward kernel. x: (B, H, W, C) bf16/fp32; scale, bias: (C,)
    fp32. Returns (y, stats), stats the saved ``[B, G, 2]``. The kernel's
    plan decides between one cluster an image and the streamed plan, whose
    workspace (counters and per-run sums) is allocated here."""
    check_args("gn_silu", x, scale, bias, num_groups)
    b, h, w, c = x.shape
    lib = build.library()
    stats = torch.empty((b, num_groups, 2), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    need = ctypes.c_longlong(0)

    def launch(work: Optional[Tensor]) -> None:
        rc = lib.rfv_gn_silu(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), 0 if work is None else work.numel(),
            ctypes.byref(need), b, h * w, c, num_groups, eps, build.DTYPE_CODES[x.dtype],
            build.stream_ptr(x),
        )
        build.check(rc, "gn_silu")

    launch(None)  # the cluster plan launches; the streamed plan names its workspace
    if need.value:
        launch(torch.empty((need.value,), device=x.device, dtype=torch.uint8))
    build.LAUNCHES["gn_silu_streamed" if need.value else "gn_silu"] += 1
    return out, stats


def launch_backward(
    x: Tensor, g: Tensor, scale: Tensor, bias: Tensor, stats: Tensor, num_groups: int,
    seed: Optional[Tensor], thresh: int, inv_keep: float, channels: Tuple[int, int] = (0, 0),
) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward kernel, with the dropout mask of ``seed`` (a (1,) int32
    tensor on x's device) or without (None); ``channels`` places x's channels
    in an unsharded activation for the mask (``gn_silu_dropout``)."""
    check_args("gn_silu_backward", x, scale, bias, num_groups)
    b, h, w, c = x.shape
    g = g.contiguous()
    build.require(g, "g", device=x.device, dtype=x.dtype, shape=x.shape)
    build.require(stats, "stats", device=x.device, dtype=torch.float32, shape=(b, num_groups, 2))
    part = torch.empty((b, c, 2), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    dscale = torch.empty((c,), device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    rc = build.library().rfv_gn_silu_backward(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
        None if seed is None else seed.data_ptr(), part.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), b, h * w, c, num_groups, thresh, inv_keep,
        channels[0], channels[1], build.DTYPE_CODES[x.dtype], build.stream_ptr(x),
    )
    build.check(rc, "gn_silu_backward")
    build.LAUNCHES["gn_silu_backward"] += 1
    return dx, dscale, dbias


def gn_silu_backward_cuda(
    x: Tensor, g: Tensor, scale: Tensor, bias: Tensor, stats: Tensor, *, num_groups: int = 8
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the backward kernel: (dx, dscale, dbias) from the forward's
    input, the cotangent and the saved statistics."""
    return launch_backward(x, g, scale, bias, stats, num_groups, None, 0, 1.0)

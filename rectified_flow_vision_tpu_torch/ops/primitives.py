"""Core NHWC compute primitives in plain PyTorch.

Counterpart of the JAX package's ``ops/primitives.py``: the same functions
on the same NHWC layout, with the same rounding points, so that the port's
tests compare like with like. Weights keep the torch layouts of the
reference checkpoints (conv OIHW, Linear (out, in)); a conv's output adds
its bias in fp32 and then rounds to the input dtype, as the JAX version
does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """cuDNN convolutions and cuBLAS matmuls in exact fp32 (TF32 off) inside,
    the previous settings back on exit. The metric networks (SynthNet, LPIPS,
    InceptionV3) run under it, so that a card computes what the CPU does up
    to summation order whatever the process's TF32 defaults are (cuDNN's is
    on)."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = prev


def conv2d(x: Tensor, w: Tensor, b: Tensor, *, stride: int = 1) -> Tensor:
    """NHWC conv with torch-style symmetric padding k//2 (OIHW weight).

    Symmetric padding, not "SAME": for stride 2 "SAME" pads 0 low / 1
    high on even sizes while torch pads (1, 1).
    """
    kh, kw = w.shape[2], w.shape[3]
    ph = kh // 2 if kh % 2 else 0
    pw = kw // 2 if kw % 2 else 0
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype), None, stride=stride, padding=(ph, pw)
    ).permute(0, 2, 3, 1)
    return (out.float() + b.float()).to(x.dtype)


def dense(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x @ w.T + b for a torch Linear weight (out, in); fp32 bias add."""
    out = torch.matmul(x, w.to(x.dtype).t())
    return (out.float() + b.float()).to(x.dtype)


def group_norm(
    x: Tensor, scale: Tensor, bias: Tensor, *, num_groups: int = 8, eps: float = 1e-5
) -> Tensor:
    """GroupNorm over an NHWC tensor (stats per (batch, group) in fp32)."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def silu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


def upsample_nearest_2x(x: Tensor) -> Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)


def sinusoidal_time_embedding(t: Tensor, dim: int) -> Tensor:
    """Sinusoidal embedding of times t in [0, 1]: frequencies
    exp(-log(10000) * i / (dim/2 - 1)), concat(sin, cos)."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(10000.0) / (half - 1))
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def spatial_attention(
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
    """Multi-head self-attention over spatial positions (NHWC in/out).

    GroupNorm -> qkv projection -> softmax attention over H*W tokens
    (fp32 logits and softmax) -> output projection -> residual add. The
    projections take Linear-layout weights: ``w_qkv`` (3Ci, C), ``w_proj``
    (C, Ci), with Ci = C, or under tensor parallelism the rank's
    ``num_heads`` heads' share of it; without ``residual`` the projection is
    returned alone (a rank's partial sum).
    """
    b, h, w, c = x.shape
    n = h * w
    ci = w_qkv.shape[0] // 3
    d = ci // num_heads
    xn = group_norm(x, norm_scale, norm_bias, num_groups=num_groups)
    qkv = dense(xn.reshape(b, n, c), w_qkv, b_qkv)
    q, k, v = (
        t.reshape(b, n, num_heads, d).transpose(1, 2) for t in qkv.split(ci, dim=-1)
    )
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(attn.float(), v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(b, n, ci)
    out = dense(out, w_proj, b_proj).reshape(b, h, w, c)
    return x + out if residual else out


def dropout(x: Tensor, rate: float, seed=None, *, train: bool) -> Tensor:
    """Inverted dropout with an explicit seed (an int or a one-element int32
    tensor): the identity in eval mode, at rate 0 or without a seed. The mask
    is the fused kernels' (``ops/gn_silu_dropout.keep_mask``), so the same
    seed drops the same elements on every path. A CUDA tensor takes the
    ``dropout`` kernel (``ops/dropout.py``), a CPU tensor its plain version."""
    from rectified_flow_vision_tpu_torch.ops import fused

    return fused.dropout(x, rate, seed, train=train)


def layer_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    """Affine-free LayerNorm over the last axis (adaLN supplies the affine):
    fp32 statistics, rounded back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    """adaLN modulation of tokens [B, T, C] by per-sample shift and scale [B, C]."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def gelu_tanh(x: Tensor) -> Tensor:
    """Tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")

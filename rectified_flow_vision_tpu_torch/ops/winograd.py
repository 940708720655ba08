"""Winograd F(2x2, 3x3) convolution in plain PyTorch (NHWC input, OHWI weight).

Counterpart of the JAX package's ``ops/winograd.py``: the same algorithm
(Lavin & Gray, "Fast Algorithms for Convolutional Neural Networks",
arXiv:1509.09308) at the same rounding points, on the port's layouts. For
every 2x2 output tile,

    Y = A^T [ (G g G^T) . (B^T d B) ] A

over the 4x4 input tile d, which overlaps its neighbours by 2. The transforms
are adds and subtracts (coefficients 0, +-1, +-1/2); the only multiplies are
the 16 tap products [B*nh*nw, C] @ [C, K], with an fp32 result.

No TPU kernel stands behind it: the JAX package computes it in XLA, outside
any Pallas kernel, and the port computes it in plain PyTorch on every device.
The tap products are one batched cuBLAS call on a CUDA tensor: bf16 operands
with an fp32 result (``aten::bmm.dtype``), on the tensor cores, as the JAX
einsum's ``preferred_element_type`` asks; fp32 operands take a plain fp32
``bmm`` (TF32 as the process sets it, off by default). The CPU has no
``bmm.dtype`` kernel, so there both operands are upcast to fp32 first: a
product of two bf16 values is exact in fp32, so the arithmetic is the same.
``bmm.dtype`` has no derivative, so the tap product is an autograd
``Function`` whose backward takes the two products dv = g u^T and du = v^T g
in the operands' dtype with an fp32 result (the cotangent rounded to that
dtype, as the TPU's default matmul precision rounds an fp32 operand to bf16),
each rounded to its operand's dtype; every other op is differentiated by
autograd, as the JAX side is by autodiff.

``fused.conv2d_fused`` routes a conv here when ``RFV_CONV_WINOGRAD`` is set,
on the JAX gate's conditions: an A/B path that the user switches on by name.
Its times on the H100 beside the conv3x3 kernel's and cuDNN's are in
``PERF.md``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# F(2x2, 3x3) transform constants (Lavin & Gray section 4.1), as the JAX module's
_BT = ((1.0, 0.0, -1.0, 0.0), (0.0, 1.0, 1.0, 0.0), (0.0, -1.0, 1.0, 0.0), (0.0, 1.0, 0.0, -1.0))
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
_AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))

# calls of ``winograd_conv3x3``, on every device, so that a run can show
# which convs took this path (it launches no kernel of the port's own)
CALLS: Dict[str, int] = {"winograd": 0}


def reset_calls() -> None:
    CALLS["winograd"] = 0


def _combine(terms: Sequence[Tensor], coeffs: Sequence[float]) -> Tensor:
    """sum_i coeffs[i] * terms[i] for coefficients in {0, +-1}: adds and
    subtracts in the terms' dtype, left to right, as the JAX einsum sums."""
    out = None
    for c, t in zip(coeffs, terms):
        if c == 0.0:
            continue
        if out is None:
            out = t if c > 0 else -t
        else:
            out = out + t if c > 0 else out - t
    return out


def _tap_product(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` batched over the taps, operands in one dtype, fp32 result."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _TapProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, u):
        ctx.save_for_backward(v, u)
        return _tap_product(v, u)

    @staticmethod
    def backward(ctx, g):
        v, u = ctx.saved_tensors
        g = g.to(v.dtype)
        dv = du = None
        if ctx.needs_input_grad[0]:
            dv = _tap_product(g, u.transpose(1, 2)).to(v.dtype)
        if ctx.needs_input_grad[1]:
            du = _tap_product(v.transpose(1, 2), g).to(u.dtype)
        return dv, du


def transform_filter(w: Tensor) -> Tensor:
    """OHWI ``[K, 3, 3, C]`` -> tap domain ``[4, 4, C, K]``: U = G g G^T per
    (C, K), in fp32 (the JAX ``transform_filter`` on the HWIO layout)."""
    g = w.float()
    G = torch.tensor(_G, dtype=torch.float32, device=w.device)
    u = torch.einsum("ui,kijc->ujck", G, g)
    return torch.einsum("ujck,vj->uvck", u, G)


def winograd_conv3x3(x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
    """3x3 / stride-1 / pad-1 NHWC conv by Winograd F(2x2, 3x3); w is OHWI.

    The same conv as ``conv3x3_plain`` for even H and W. V = B^T d B in x's
    dtype, U = G g G^T in fp32 rounded to x's dtype, the tap products with an
    fp32 result, A^T m A and the bias in fp32, the output in x's dtype."""
    bsz, h, wid, c = x.shape
    if tuple(w.shape[1:3]) != (3, 3):
        raise ValueError(f"winograd_conv3x3: 3x3 weights only, got OHWI {tuple(w.shape)}")
    if h % 2 or wid % 2:
        raise ValueError(f"winograd_conv3x3: even spatial dims only, got {h}x{wid}")
    CALLS["winograd"] += 1
    k = w.shape[0]
    nh, nw = h // 2, wid // 2
    dtype = x.dtype

    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    # element (i, j) of every 4x4 tile is xp[:, i:i + 2nh - 1:2, j:j + 2nw - 1:2]:
    # B^T over the tile's rows, then over its columns, each pass rounded to x's dtype
    rows = [xp[:, i:i + 2 * nh - 1:2] for i in range(4)]
    v = []
    for coeffs in _BT:
        r = _combine(rows, coeffs)
        cols = [r[:, :, j:j + 2 * nw - 1:2] for j in range(4)]
        v.extend(_combine(cols, cv) for cv in _BT)
    v = torch.stack(v).reshape(16, bsz * nh * nw, c)
    u = transform_filter(w).to(dtype).reshape(16, c, k)

    m = _TapProduct.apply(v, u).reshape(4, 4, bsz, nh, nw, k)

    # Y = A^T m A -> [2, 2, B, nh, nw, K], interleaved into [B, H, W, K]
    t = [_combine(list(m), cu) for cu in _AT]
    y = torch.stack([torch.stack([_combine(list(tp), cv) for cv in _AT]) for tp in t])
    y = y.permute(2, 3, 0, 4, 1, 5).reshape(bsz, h, wid, k)
    if b is not None:
        y = y + b.float()
    return y.to(dtype)


def conv2d_winograd(x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tensor:
    """``fused.conv2d_fused``'s Winograd route: the weight cast to x's dtype
    first, as the JAX ``conv2d_winograd`` casts it."""
    return winograd_conv3x3(x, w.to(x.dtype), b)

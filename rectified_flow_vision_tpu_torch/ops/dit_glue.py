"""The DiT block's passes between its GEMMs: CUDA kernels and their plain versions.

Replaces no Pallas TPU kernel: on the TPU, XLA fuses the JAX package's
``layer_norm``, ``modulate``, the dense bias add, GELU and the gated
residual into the ops around them. The port's eager composition
(``ops/primitives.py``) makes one pass over the tokens for each of them, and
a latent serving call spent most of its device time there. Three kernels
(``csrc/dit_glue.cu``), each bound by bytes on the H100, read their inputs
once and write once:

    ln_modulate(x, shift, scale)          LN(x) * (1 + scale) + shift
    bias_act(y, b, act)                   act(y + b): the dense epilogue
    gated_residual(tokens, y, b, gate)    tokens + gate * (y + b)

``y`` is a GEMM's output (``torch.matmul``, rounded to the working dtype),
``b`` the fp32 bias; ``shift``, ``scale`` and ``gate`` are ``[B, C]`` rows,
in the model strided views of the chunked adaLN projection, which the
kernels read in place. The plain versions are the eager composition itself,
and the kernels keep its rounding points: the epilogues are bit-equal to it,
ln_modulate differs by the order of its fp32 sums. No kernel has a
backward: ``ops/fused.py`` differentiates the plain versions in the
backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import primitives as P

Tensor = torch.Tensor

ACTS = {None: 0, "gelu_tanh": 1}
LN_EPS = 1e-6
VECTOR = 8  # channels a 16-byte vector of bf16 holds: C must be a multiple
LN_MAX_VECTORS = 1024  # ln_modulate holds a row in registers: 1024 vectors of 16 bytes


def supports(c: int) -> bool:
    """Whether the kernels take rows of ``c`` channels (a multiple of 8,
    so that every row starts on a 16-byte vector)."""
    return c > 0 and c % VECTOR == 0


def ln_modulate_plain(x: Tensor, shift: Tensor, scale: Tensor, eps: float = LN_EPS) -> Tensor:
    """Affine-free LayerNorm of tokens [B, T, C] modulated by [B, C] rows."""
    return P.modulate(P.layer_norm(x, eps), shift, scale)


def bias_act_plain(y: Tensor, b: Tensor, act: Optional[str] = None) -> Tensor:
    """``P.dense``'s epilogue on a GEMM output: the bias added in fp32 and
    rounded to y's dtype, then the activation."""
    _act_code(act)
    h = (y.float() + b.float()).to(y.dtype)
    return P.gelu_tanh(h) if act == "gelu_tanh" else h


def gated_residual_plain(tokens: Tensor, y: Tensor, b: Tensor, gate: Tensor) -> Tensor:
    """tokens + gate * (y + b), each op rounded to the tokens' dtype."""
    return tokens + gate[:, None, :] * bias_act_plain(y, b)


def _act_code(act: Optional[str]) -> int:
    if act not in ACTS:
        raise ValueError(f"bias_act: activation {act!r} not one of {sorted(map(str, ACTS))}")
    return ACTS[act]


def _check_rows(kernel: str, x: Tensor, name: str = "x") -> int:
    """x: [B, T, C] contiguous with C a kernel width, fewer than 2^31
    vectors of 16 bytes (the kernels' 32-bit index); returns C."""
    build.require_cuda(x, kernel)
    if x.ndim != 3:
        raise ValueError(f"{kernel}: {name} must be [B, T, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if not supports(c):
        raise ValueError(f"{kernel}: {c} channels is not a multiple of {VECTOR}")
    if x.numel() * x.element_size() // 16 >= 2**31:
        raise ValueError(f"{kernel}: {name} {tuple(x.shape)} holds 2^31 vectors or more")
    build.require(x, name, device=x.device, dtype=x.dtype, shape=x.shape)
    if x.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} is not 16-byte aligned")
    return c


def _rows(kernel: str, name: str, m: Tensor, x: Tensor) -> Tensor:
    """A [B, C] row tensor as the kernels read it: x's dtype and device, a
    unit stride along C, 16-byte aligned rows. A strided view that complies
    is kept as it is; anything else is copied."""
    b, _, c = x.shape
    build.require_cuda(m, kernel)
    if m.dtype != x.dtype or tuple(m.shape) != (b, c) or m.device != x.device:
        raise ValueError(
            f"{kernel}: {name} must be {x.dtype} [{b}, {c}] on {x.device}, "
            f"got {m.dtype} {tuple(m.shape)} on {m.device}")
    vec = 16 // m.element_size()
    if m.stride(1) != 1 or m.stride(0) % vec or m.data_ptr() % 16:
        m = m.contiguous()
    return m


def _bias(kernel: str, b: Tensor, x: Tensor) -> Tensor:
    c = x.shape[-1]
    if b.dtype != torch.float32 or tuple(b.shape) != (c,) or b.device != x.device:
        raise ValueError(f"{kernel}: b must be float32 [{c}] on {x.device}, "
                         f"got {b.dtype} {tuple(b.shape)} on {b.device}")
    return b if b.is_contiguous() and b.data_ptr() % 16 == 0 else b.contiguous()


def ln_modulate_cuda(x: Tensor, shift: Tensor, scale: Tensor, eps: float = LN_EPS) -> Tensor:
    """Launch ``ln_modulate``. x: [B, T, C] bf16 or fp32, contiguous, C a
    multiple of 8 (at most 8192 in bf16, 4096 in fp32); shift, scale:
    [B, C] of x's dtype, read in place when their rows are 16-byte aligned
    with a unit stride along C, as the chunks of one [B, 6C] projection."""
    c = _check_rows("ln_modulate", x)
    if c // (16 // x.element_size()) > LN_MAX_VECTORS:
        raise ValueError(f"ln_modulate: {c} channels exceed the {LN_MAX_VECTORS} vectors of "
                         "16 bytes that a row holds in registers")
    shift = _rows("ln_modulate", "shift", shift, x)
    scale = _rows("ln_modulate", "scale", scale, x)
    if shift.stride(0) != scale.stride(0):
        shift, scale = shift.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, t, _ = x.shape
    rc = build.library().rfv_ln_modulate(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(), b * t, c, t,
        shift.stride(0), float(eps), build.DTYPE_CODES[x.dtype], build.stream_ptr(x),
    )
    build.check(rc, "ln_modulate")
    build.LAUNCHES["ln_modulate"] += 1
    return out


def bias_act_cuda(y: Tensor, b: Tensor, act: Optional[str] = None) -> Tensor:
    """Launch ``bias_act``. y: [B, T, C] bf16 or fp32, contiguous, C a
    multiple of 8; b: fp32 [C]; act None or ``"gelu_tanh"``."""
    code = _act_code(act)
    c = _check_rows("bias_act", y, "y")
    b = _bias("bias_act", b, y)
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    rc = build.library().rfv_bias_act(
        y.data_ptr(), b.data_ptr(), out.data_ptr(), y.numel(), c, code,
        build.DTYPE_CODES[y.dtype], build.stream_ptr(y),
    )
    build.check(rc, "bias_act")
    build.LAUNCHES["bias_act"] += 1
    return out


def gated_residual_cuda(tokens: Tensor, y: Tensor, b: Tensor, gate: Tensor) -> Tensor:
    """Launch ``gated_residual``. tokens, y: [B, T, C] of one dtype (bf16 or
    fp32), contiguous, C a multiple of 8; b: fp32 [C]; gate: [B, C] of that
    dtype, read in place as ``ln_modulate``'s shift."""
    c = _check_rows("gated_residual", tokens, "tokens")
    _check_rows("gated_residual", y, "y")
    if y.shape != tokens.shape or y.dtype != tokens.dtype:
        raise ValueError(f"gated_residual: y {y.dtype} {tuple(y.shape)} against tokens "
                         f"{tokens.dtype} {tuple(tokens.shape)}")
    b = _bias("gated_residual", b, tokens)
    gate = _rows("gated_residual", "gate", gate, tokens)
    out = torch.empty_like(tokens)
    if tokens.numel() == 0:
        return out
    rc = build.library().rfv_gated_residual(
        tokens.data_ptr(), y.data_ptr(), b.data_ptr(), gate.data_ptr(), out.data_ptr(),
        tokens.numel(), c, tokens.shape[1], gate.stride(0), build.DTYPE_CODES[tokens.dtype],
        build.stream_ptr(tokens),
    )
    build.check(rc, "gated_residual")
    build.LAUNCHES["gated_residual"] += 1
    return out

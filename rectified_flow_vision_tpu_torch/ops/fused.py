"""Dispatch between the port's CUDA kernels and their plain versions.

Counterpart of the JAX package's ``ops/fused.py``. Between a kernel and its
plain version the only switch is the tensor's device: a CPU tensor takes the
plain PyTorch version under ordinary autograd, a CUDA tensor takes the
kernel, and any other device raises. There is no size cap (the JAX side's
VMEM slab cap is a TPU limit) and no fallback when a build or a launch fails.
The conv has its contract besides: a conv outside ``conv3x3.supports`` (not
3x3/stride 1, or channels not multiples of 64) is the plain conv on every
device, as in the JAX package. A tensor-parallel rank's slice of a conv is
judged by the whole conv: a site's slice takes the kernel or raises.

One switch is the user's, by name, as in the JAX package:
``RFV_CONV_WINOGRAD`` set (to anything but the empty string, read at each
call) sends every stride-1 3x3 conv of even height and width at this module's
conv site, whatever its channels, to the Winograd F(2x2, 3x3) conv of
``ops/winograd.py`` (plain PyTorch, its tap products on cuBLAS) on every
device, tensor-parallel slices included: an A/B path, not a fallback. Such a
conv launches neither the conv3x3 kernel nor cuDNN.

On a CUDA tensor each kernel runs inside a ``torch.autograd.Function``.
The GroupNorm kernels, flash attention and the standalone dropout have
hand-written backwards. ``gn_silu`` and ``gn_silu_dropout`` save x and each
(image, group)'s mean and 1/sigma and launch the ``gn_silu_backward`` kernel
(the port's counterpart of the JAX package's fused XLA VJP), which for the
dropout variant regenerates the mask from the saved seed, so no mask tensor
is ever kept. Flash attention, as its TPU counterpart, saves q, k, v, its
output and the per-row log-sum-exp and launches the dq and dkv kernels;
dropout's gradient is the dropout kernel applied to the cotangent with the
saved seed. The conv and the attention block, as in the JAX package's custom
VJPs, save their inputs and differentiate the plain version in the backward.
Flash attention has the JAX package's rule on shape besides
(``FA.use_flash``): short sequences take the plain attention on every
device, as there.

The DiT block's glue between its GEMMs (``ln_modulate``, ``bias_act``,
``gated_residual``; ``ops/dit_glue.py``) takes the kernel on a CUDA tensor in
every forward, sampling and training alike; a width the kernels do not take
(C not a multiple of 8) raises there. Its kernels have no backward yet: the
backward differentiates the plain version (the eager composition) from the
saved inputs, as the conv's does.

FLUX's QK-RMSNorm + rotary embedding (``qk_norm_rope``;
``ops/qk_norm_rope.py``) takes the kernel on a CUDA tensor in every forward,
one launch a stream into the joint ``[B, T, 3, H, D]`` buffer that flash
reads; its backward, too, differentiates the plain version.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from rectified_flow_vision_tpu_torch.ops import attention as A
from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
from rectified_flow_vision_tpu_torch.ops import dit_glue as DG
from rectified_flow_vision_tpu_torch.ops import dropout as DR
from rectified_flow_vision_tpu_torch.ops import flash_attention as FA
from rectified_flow_vision_tpu_torch.ops import gn_silu as G
from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D
from rectified_flow_vision_tpu_torch.ops import primitives as P
from rectified_flow_vision_tpu_torch.ops import qk_norm_rope as QR
from rectified_flow_vision_tpu_torch.ops import winograd as W

Tensor = torch.Tensor


def _on_cpu(x: Tensor) -> bool:
    return x.device.type == "cpu"


def _plain_grads(
    fn: Callable[..., Tensor], inputs: Sequence[Tensor], needed: Sequence[bool], g: Tensor
) -> Tuple[Optional[Tensor], ...]:
    """Gradients of ``fn(*inputs)`` against cotangent ``g``, for the inputs
    flagged in ``needed`` (None for the rest)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needed)]
        out = fn(*leaves)
        wanted = [t for t, need in zip(leaves, needed) if need]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
    return tuple(next(grads) if need else None for need in needed)


def _gn_grads(ctx, grads):
    """The GroupNorm backward's (dx, dscale, dbias), None where not needed."""
    return tuple(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad[:3]))


class _GnSilu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups):
        out, stats = G.gn_silu_cuda(x, scale, bias, num_groups=num_groups)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.num_groups = num_groups
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats = ctx.saved_tensors
        grads = G.gn_silu_backward_cuda(x, g, scale, bias, stats, num_groups=ctx.num_groups)
        return (*_gn_grads(ctx, grads), None)


class _GnSiluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, seed, rate, num_groups, channels):
        out, stats = D.gn_silu_dropout_cuda(x, scale, bias, seed, rate, num_groups=num_groups,
                                            channels=channels)
        ctx.save_for_backward(x, scale, bias, stats, seed)
        ctx.rate, ctx.num_groups, ctx.channels = rate, num_groups, channels
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats, seed = ctx.saved_tensors
        grads = D.gn_silu_dropout_backward_cuda(x, g, scale, bias, stats, seed, ctx.rate,
                                                num_groups=ctx.num_groups,
                                                channels=ctx.channels)
        return (*_gn_grads(ctx, grads), None, None, None, None)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return C.conv3x3_cuda(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # through the plain conv with a zero bias; the bias gradient is the
        # sum of g, taken in fp32 where the bias was added
        zero = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
        dx, dw = _plain_grads(
            lambda x_, w_: C.conv3x3_plain(x_, w_, zero), (x, w), ctx.needs_input_grad[:2], g
        )
        db = g.float().sum(dim=(0, 1, 2)) if ctx.needs_input_grad[2] else None
        return dx, dw, db


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ns, nb, wq, bq, wp, bp, num_heads, num_groups, residual):
        ctx.save_for_backward(x, ns, nb, wq, bq, wp, bp)
        ctx.num_heads, ctx.num_groups, ctx.residual = num_heads, num_groups, residual
        return A.attention_block_cuda(
            x, ns, nb, wq, bq, wp, bp, num_heads=num_heads, num_groups=num_groups,
            residual=residual,
        )

    @staticmethod
    def backward(ctx, g):
        def plain(*args):
            return A.attention_block_plain(
                *args, num_heads=ctx.num_heads, num_groups=ctx.num_groups,
                residual=ctx.residual,
            )

        grads = _plain_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[:7], g)
        return (*grads, None, None, None)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = FA.flash_attention_cuda(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return FA.flash_attention_backward_cuda(*ctx.saved_tensors, g)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(seed)
        ctx.rate = rate
        return DR.dropout_cuda(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        (seed,) = ctx.saved_tensors
        return DR.dropout_cuda(g.contiguous(), seed, ctx.rate), None, None


class _LnModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, scale):
        ctx.save_for_backward(x, shift, scale)
        return DG.ln_modulate_cuda(x, shift, scale)

    @staticmethod
    def backward(ctx, g):
        return _plain_grads(DG.ln_modulate_plain, ctx.saved_tensors, ctx.needs_input_grad, g)


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, b, act):
        ctx.save_for_backward(y, b)
        ctx.act = act
        return DG.bias_act_cuda(y, b, act)

    @staticmethod
    def backward(ctx, g):
        grads = _plain_grads(lambda y, b: DG.bias_act_plain(y, b, ctx.act), ctx.saved_tensors,
                             ctx.needs_input_grad[:2], g)
        return (*grads, None)


class _GatedResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, y, b, gate):
        ctx.save_for_backward(tokens, y, b, gate)
        return DG.gated_residual_cuda(tokens, y, b, gate)

    @staticmethod
    def backward(ctx, g):
        return _plain_grads(DG.gated_residual_plain, ctx.saved_tensors, ctx.needs_input_grad, g)


class _QkNormRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cos, sin, heads, *flat):
        ctx.save_for_backward(cos, sin, *flat)
        ctx.heads = heads
        return QR.joint_cuda(_streams(flat), cos, sin, heads)

    @staticmethod
    def backward(ctx, g):
        cos, sin, *flat = ctx.saved_tensors

        def plain(*leaves):
            return QR.joint_plain(_streams(leaves), cos, sin, ctx.heads)

        grads = _plain_grads(plain, flat, ctx.needs_input_grad[3:], g)
        return (None, None, None, *grads)


def _streams(flat: Sequence[Tensor]) -> List[Tuple[Tensor, Tensor, Tensor]]:
    return [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]


def gn_silu(x: Tensor, scale: Tensor, bias: Tensor, *, num_groups: int = 8) -> Tensor:
    """Fused GroupNorm(num_groups) + SiLU over an NHWC tensor."""
    if _on_cpu(x):
        return G.gn_silu_plain(x, scale, bias, num_groups=num_groups)
    return _GnSilu.apply(x, scale, bias, num_groups)


def gn_silu_dropout(
    x: Tensor,
    scale: Tensor,
    bias: Tensor,
    rate: float,
    seed: Optional[D.Seed],
    *,
    train: bool,
    num_groups: int = 8,
    channels: D.Channels = None,
) -> Tensor:
    """GroupNorm + SiLU + dropout as one fused pass. In eval mode, at rate 0
    or without a seed it is ``gn_silu``. ``channels`` = (offset, total) keys
    the mask of a tensor-parallel rank's channel slice by its place in the
    whole activation (``ops/gn_silu_dropout.py``)."""
    if not train or rate <= 0.0 or seed is None:
        return gn_silu(x, scale, bias, num_groups=num_groups)
    if _on_cpu(x):
        return D.gn_silu_dropout_plain(x, scale, bias, seed, rate, num_groups=num_groups,
                                       channels=channels)
    seed = D.seed_tensor(seed, x.device)
    return _GnSiluDropout.apply(x, scale, bias, seed, float(rate), num_groups, channels)


def conv2d_fused(
    x: Tensor, w_ohwi: Tensor, b: Tensor, *, stride: int = 1, shards: Tuple[int, int] = (1, 1)
) -> Tensor:
    """NHWC conv with an OHWI weight: the conv3x3 kernel inside its contract,
    the plain conv outside it. ``shards`` = (in, out): the weight is a
    tensor-parallel rank's slice, 1 / in of the whole conv's input channels
    and 1 / out of its output channels; the whole conv decides the site, and
    on a CUDA tensor the kernel raises if the slice is outside what it takes.
    With ``RFV_CONV_WINOGRAD`` set, a stride-1 3x3 conv of even H and W is
    the Winograd conv instead, on every device (the JAX gate, tested first)."""
    cout, kh, kw, cin = w_ohwi.shape
    if (os.environ.get("RFV_CONV_WINOGRAD") and stride == 1 and (kh, kw) == (3, 3)
            and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
        return W.conv2d_winograd(x, w_ohwi, b)
    whole = (cout * shards[1], kh, kw, cin * shards[0])
    if C.supports((*x.shape[:-1], whole[3]), whole, stride):
        if _on_cpu(x):
            return C.conv3x3_plain(x, w_ohwi, b)
        return _Conv3x3.apply(x, w_ohwi, b)
    return P.conv2d(x, w_ohwi.permute(0, 3, 1, 2), b, stride=stride)


def attention(
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
    """Spatial self-attention block (norm -> qkv -> attn -> proj -> +x); a
    tensor-parallel rank passes its heads' weights and ``residual=False``
    (``ops/attention.py``)."""
    if _on_cpu(x):
        return A.attention_block_plain(
            x, norm_scale, norm_bias, w_qkv, b_qkv, w_proj, b_proj,
            num_heads=num_heads, num_groups=num_groups, residual=residual,
        )
    return _Attention.apply(
        x, norm_scale, norm_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads, num_groups,
        residual,
    )


def flash_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Non-causal multi-head attention over [B, T, H, D], scale 1/sqrt(D).
    Sequences inside ``FA.use_flash`` take the flash kernels (forward and
    backward) on a CUDA tensor; shorter ones are the plain attention on
    every device, as in the JAX package."""
    if not FA.use_flash(q.shape[1]) or _on_cpu(q):
        return FA.flash_attention_plain(q, k, v)
    return _FlashAttention.apply(q, k, v)


def dropout(x: Tensor, rate: float, seed: Optional[D.Seed], *, train: bool) -> Tensor:
    """Inverted dropout of any tensor with an explicit seed; the identity in
    eval mode, at rate 0 or without a seed."""
    if not train or rate <= 0.0 or seed is None:
        return x
    if _on_cpu(x):
        return DR.dropout_plain(x, seed, rate)
    return _Dropout.apply(x.contiguous(), D.seed_tensor(seed, x.device), float(rate))


def ln_modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    """Affine-free LayerNorm of tokens [B, T, C], then ``* (1 + scale) + shift``
    with [B, C] rows (adaLN)."""
    if _on_cpu(x):
        return DG.ln_modulate_plain(x, shift, scale)
    return _LnModulate.apply(x.contiguous(), shift, scale)


def bias_act(y: Tensor, b: Tensor, act: Optional[str] = None) -> Tensor:
    """A dense layer's epilogue on its GEMM output [B, T, C]: the fp32 bias,
    then ``act`` (None or ``"gelu_tanh"``)."""
    if _on_cpu(y):
        return DG.bias_act_plain(y, b, act)
    return _BiasAct.apply(y.contiguous(), b, act)


def gated_residual(tokens: Tensor, y: Tensor, b: Tensor, gate: Tensor) -> Tensor:
    """tokens + gate * (y + b): a dense layer's epilogue, gated by [B, C] rows
    and added to the residual stream."""
    if _on_cpu(tokens):
        return DG.gated_residual_plain(tokens, y, b, gate)
    return _GatedResidual.apply(tokens.contiguous(), y.contiguous(), b, gate)


def qk_norm_rope(streams: Sequence[Tuple[Tensor, Tensor, Tensor]], cos: Tensor, sin: Tensor,
                 heads: int) -> Tensor:
    """The joint ``[B, T, 3, H, D]`` q, k, v of an attention over streams of
    tokens, each ``(qkv [B, T_s, 3C], q_scale [D], k_scale [D])`` in token
    order: q and k RMS-normalised, scaled and rotated by the rows of the fp32
    ``[T, D / 2]`` tables ``cos`` / ``sin``, v as it is."""
    if _on_cpu(streams[0][0]):
        return QR.joint_plain(streams, cos, sin, heads)
    flat = [x.contiguous() if i % 3 == 0 else x for s in streams for i, x in enumerate(s)]
    return _QkNormRope.apply(cos, sin, heads, *flat)

"""FLUX velocity-field backbone as an ``nn.Module``: a text-to-image
rectified-flow transformer (Black Forest Labs, FLUX.1; ``src/flux/model.py``
and ``src/flux/modules/layers.py`` of github.com/black-forest-labs/flux).

No counterpart in the JAX package. Parameter names are the published
model's, so that its state dict loads by name:

    img_in, txt_in                       token embeddings (packed latents, T5 tokens)
    time_in.{in,out}_layer               MLP on 256 sinusoidal features of 1000 t
    vector_in.{in,out}_layer             MLP on the pooled CLIP vector
    double_blocks.{i}                    text and image streams, joint attention
        {img,txt}_mod.lin                6 x hidden modulation from SiLU(vec)
        {img,txt}_attn.{qkv,proj}        the stream's projections
        {img,txt}_attn.norm.{query,key}_norm.scale   QK-RMSNorm scales [D]
        {img,txt}_mlp.{0,2}              the stream's GELU-tanh MLP
    single_blocks.{i}                    one stream over text + image tokens
        linear1                          hidden -> 3 x hidden (qkv) + MLP hidden
        linear2                          attention + GELU(MLP) -> hidden
        norm.{query,key}_norm.scale, modulation.lin
    final_layer.{adaLN_modulation.1,linear}   final adaLN and head, image tokens

The conditioning vector ``vec = time_in(emb(1000 t)) + vector_in(pooled)``
drives every modulation (shift, scale, gate). Latents [B, H, W, C] are packed
2 x 2 into tokens of 4C channels, (c, ph, pw) order, and unpacked at the end.
Image tokens sit at positions (0, row, col) of the packed grid, text tokens
at 0: RoPE over axes of ``axes_dim`` widths rotates adjacent pairs of each
head by position x theta^(-2j / axis width), and leaves text unrotated.
Attention is over ``cat(txt, img)``.

The passes between GEMMs take the hand-written kernels on a CUDA tensor, as
``models/dit.py``'s do: every LayerNorm + modulate ``ln_modulate``, every
token-wise bias epilogue ``bias_act`` (GELU in the MLPs), every gated
residual ``gated_residual``, and QK-RMSNorm + RoPE ``qk_norm_rope``, which
writes each stream's q, k and v straight into the joint buffer that flash
attention reads, text rows first. The single block's ``linear1`` runs as two
GEMMs (qkv, MLP) so that each epilogue reads one contiguous output, and
``linear2`` as two accumulating GEMMs over the attention output and the GELU
output, so that nothing concatenates them. The GEMMs on ``vec`` (the
modulations, the embedders) stay ``P.dense``.

Parameters are fp32; ``forward(x, t, dtype=, cond=)`` sees them as
``models.unet`` describes: rounded, detached, cached copies for sampling.
``cond`` carries the prompt's encoder outputs by name: ``txt`` [B, L, 4096]
(T5 tokens) and ``vec`` [B, 768] (pooled CLIP); ``cond_shapes`` gives a
row's shapes. Spans (``utils.profiling.annotate``): ``rfv.flux.double`` and
``rfv.flux.single`` around each block. No training path, no parallelism.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from rectified_flow_vision_tpu_torch.models.dit import _dense, _matmul
from rectified_flow_vision_tpu_torch.models.unet import _ParamCache, _View
from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import primitives as P
from rectified_flow_vision_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

TIME_BASIS = 256  # sinusoidal features of the timestep, as FLUX's timestep_embedding
TIME_FACTOR = 1000.0  # FLUX embeds 1000 t


@dataclass(frozen=True)
class FluxConfig:
    input_size: int = 128  # latent height = width
    in_channels: int = 16  # latent channels (4 x as many a packed token)
    patch_size: int = 2
    hidden_size: int = 3072
    num_heads: int = 24
    mlp_ratio: float = 4.0
    depth: int = 19  # double-stream blocks
    depth_single_blocks: int = 38
    context_in_dim: int = 4096
    context_tokens: int = 256
    vec_in_dim: int = 768
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    qkv_bias: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


def timestep_embedding(t: Tensor, dim: int = TIME_BASIS, max_period: float = 10000.0) -> Tensor:
    """FLUX's sinusoidal embedding of 1000 t: cos then sin of 1000 t times
    max_period^(-i / (dim / 2)), fp32 [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = (TIME_FACTOR * t.float())[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def positions(text_tokens: int, grid_h: int, grid_w: int, device=None) -> Tensor:
    """Position ids [L + h w, 3] of the joint sequence: text tokens at 0,
    image tokens at (0, row, col) in row-major order."""
    ids = torch.zeros((text_tokens + grid_h * grid_w, 3), dtype=torch.float64, device=device)
    ids[text_tokens:, 1] = torch.arange(grid_h, dtype=torch.float64,
                                        device=device).repeat_interleave(grid_w)
    ids[text_tokens:, 2] = torch.arange(grid_w, dtype=torch.float64, device=device).repeat(grid_h)
    return ids


def rope_tables(ids: Tensor, axes_dim: Sequence[int], theta: float) -> Tuple[Tensor, Tensor]:
    """fp32 (cos, sin) [T, D / 2] of the angles pos_a x theta^(-2j / d_a),
    axis by axis, computed in float64 as FLUX's ``rope``."""
    angles = []
    for a, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=ids.device) / d)
        angles.append(ids[:, a, None].double() * omega[None])
    ang = torch.cat(angles, dim=-1)
    return torch.cos(ang).float().contiguous(), torch.sin(ang).float().contiguous()


def pack(x: Tensor, p: int) -> Tensor:
    """NHWC latents -> [B, (H / p)(W / p), C p p] tokens, (c, ph, pw) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def unpack(tokens: Tensor, shape, p: int) -> Tensor:
    b, h, w, c = shape
    x = tokens.reshape(b, h // p, w // p, c, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h, w, c)


class _RMSNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))


class _QKNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.query_norm = _RMSNorm(dim)
        self.key_norm = _RMSNorm(dim)

    def scales(self, v: _View) -> Tuple[Tensor, Tensor]:
        return v(self.query_norm.scale, "f32"), v(self.key_norm.scale, "f32")


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int, head_dim: int, qkv_bias: bool) -> None:
        super().__init__()
        self.qkv = nn.Linear(hidden, 3 * hidden, bias=qkv_bias)
        self.norm = _QKNorm(head_dim)
        self.proj = nn.Linear(hidden, hidden)


class _Modulation(nn.Module):
    def __init__(self, hidden: int, parts: int) -> None:
        super().__init__()
        self.lin = nn.Linear(hidden, parts * hidden)


class _MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int) -> None:
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden)
        self.out_layer = nn.Linear(hidden, hidden)

    def embed(self, x: Tensor, v: _View) -> Tensor:
        return v.dense(P.silu(v.dense(x, self.in_layer)), self.out_layer)


def _qkv(v: _View, x: Tensor, m: nn.Linear) -> Tensor:
    """A qkv projection with its bias epilogue (none without a bias)."""
    y = _matmul(x, v(m.weight))
    return y if m.bias is None else fused.bias_act(y, v(m.bias, "f32"))


def _gated(v: _View, tokens: Tensor, x: Tensor, m: nn.Linear, gate: Tensor) -> Tensor:
    return fused.gated_residual(tokens, _matmul(x, v(m.weight)), v(m.bias, "f32"), gate)


class DoubleStreamBlock(nn.Module):
    """Text and image tokens with weights of their own, one joint attention."""

    def __init__(self, cfg: FluxConfig) -> None:
        super().__init__()
        h = cfg.hidden_size
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", _Modulation(h, 6))
            setattr(self, f"{s}_attn", _SelfAttention(h, cfg.head_dim, cfg.qkv_bias))
            setattr(self, f"{s}_mlp", nn.Sequential(nn.Linear(h, cfg.mlp_dim), nn.GELU("tanh"),
                                                    nn.Linear(cfg.mlp_dim, h)))

    def forward(self, img: Tensor, txt: Tensor, vec: Tensor, v: _View, heads: int,
                rope: Tuple[Tensor, Tensor]) -> Tuple[Tensor, Tensor]:
        b, t_txt, hidden = txt.shape
        sv = P.silu(vec)
        mods = {s: v.dense(sv, getattr(self, f"{s}_mod").lin).chunk(6, dim=-1)
                for s in ("txt", "img")}
        streams = []
        for s, x in (("txt", txt), ("img", img)):
            attn = getattr(self, f"{s}_attn")
            shift, scale = mods[s][0], mods[s][1]
            streams.append((_qkv(v, fused.ln_modulate(x, shift, scale), attn.qkv),
                            *attn.norm.scales(v)))
        q, k, val = fused.qk_norm_rope(streams, *rope, heads).unbind(2)
        att = fused.flash_attention(q, k, val).reshape(b, -1, hidden)
        out = []
        for s, x, a in (("txt", txt, att[:, :t_txt]), ("img", img, att[:, t_txt:])):
            _, _, gate1, shift2, scale2, gate2 = mods[s]
            mlp = getattr(self, f"{s}_mlp")
            x = _gated(v, x, a, getattr(self, f"{s}_attn").proj, gate1)
            hmod = _dense(v, fused.ln_modulate(x, shift2, scale2), mlp[0], act="gelu_tanh")
            out.append(_gated(v, x, hmod, mlp[2], gate2))
        txt, img = out
        return img, txt


class SingleStreamBlock(nn.Module):
    """One stream over text + image tokens: attention and a GELU MLP in
    parallel from one modulated LayerNorm, one gated residual."""

    def __init__(self, cfg: FluxConfig) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.linear1 = nn.Linear(h, 3 * h + cfg.mlp_dim)
        self.linear2 = nn.Linear(h + cfg.mlp_dim, h)
        self.norm = _QKNorm(cfg.head_dim)
        self.modulation = _Modulation(h, 3)

    def forward(self, x: Tensor, vec: Tensor, v: _View, heads: int,
                rope: Tuple[Tensor, Tensor]) -> Tensor:
        b, t, hidden = x.shape
        shift, scale, gate = v.dense(P.silu(vec), self.modulation.lin).chunk(3, dim=-1)
        hmod = fused.ln_modulate(x, shift, scale)
        w1, b1 = v(self.linear1.weight), v(self.linear1.bias, "f32")
        qkv = fused.bias_act(_matmul(hmod, w1[:3 * hidden]), b1[:3 * hidden])
        q, k, val = fused.qk_norm_rope([(qkv, *self.norm.scales(v))], *rope, heads).unbind(2)
        att = fused.flash_attention(q, k, val).reshape(b * t, hidden)
        mlp = fused.bias_act(_matmul(hmod, w1[3 * hidden:]), b1[3 * hidden:], "gelu_tanh")
        w2 = v(self.linear2.weight)
        y = _matmul(att, w2[:, :hidden])
        y = y.addmm_(mlp.reshape(b * t, -1), w2[:, hidden:].t())  # linear2 of the two, uncat
        return fused.gated_residual(x, y.reshape(b, t, hidden), v(self.linear2.bias, "f32"), gate)


class _LastLayer(nn.Module):
    def __init__(self, hidden: int, out_dim: int) -> None:
        super().__init__()
        self.linear = nn.Linear(hidden, out_dim)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 2 * hidden))


class Flux(nn.Module):
    """FLUX velocity field: ``flux(x, t, dtype=..., cond={"txt", "vec"})``
    with x NHWC latents [B, H, W, C], t [B]."""

    def __init__(self, input_size: int = 128, in_channels: int = 16, patch_size: int = 2,
                 hidden_size: int = 3072, num_heads: int = 24, mlp_ratio: float = 4.0,
                 depth: int = 19, depth_single_blocks: int = 38, context_in_dim: int = 4096,
                 context_tokens: int = 256, vec_in_dim: int = 768,
                 axes_dim: Sequence[int] = (16, 56, 56), theta: int = 10000,
                 qkv_bias: bool = True) -> None:
        super().__init__()
        self.cfg = cfg = FluxConfig(
            input_size=input_size, in_channels=in_channels, patch_size=patch_size,
            hidden_size=hidden_size, num_heads=num_heads, mlp_ratio=mlp_ratio, depth=depth,
            depth_single_blocks=depth_single_blocks, context_in_dim=context_in_dim,
            context_tokens=context_tokens, vec_in_dim=vec_in_dim, axes_dim=tuple(axes_dim),
            theta=theta, qkv_bias=qkv_bias)
        if sum(cfg.axes_dim) != cfg.head_dim or any(d % 2 for d in cfg.axes_dim):
            raise ValueError(f"axes_dim {cfg.axes_dim} must be even widths summing to the head "
                             f"width {cfg.head_dim}")
        h, p = cfg.hidden_size, cfg.patch_size
        self.img_in = nn.Linear(in_channels * p * p, h)
        self.time_in = _MLPEmbedder(TIME_BASIS, h)
        self.vector_in = _MLPEmbedder(vec_in_dim, h)
        self.txt_in = nn.Linear(context_in_dim, h)
        self.double_blocks = nn.ModuleList(DoubleStreamBlock(cfg) for _ in range(depth))
        self.single_blocks = nn.ModuleList(SingleStreamBlock(cfg) for _ in range(depth_single_blocks))
        self.final_layer = _LastLayer(h, in_channels * p * p)
        self._params = _ParamCache()
        self._rope: Dict[tuple, Tuple[Tensor, Tensor]] = {}

    @property
    def cond_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The shapes of one image's conditioning rows, by name."""
        return {"txt": (self.cfg.context_tokens, self.cfg.context_in_dim),
                "vec": (self.cfg.vec_in_dim,)}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch's default for every dense layer, U(-1/sqrt(fan_in),
        1/sqrt(fan_in)) for weights and biases, and scales of 1, drawn in
        module order from ``generator`` on its own device (2.5 B parameters
        at the published widths: no copy through the host)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.weight.shape[1])
                for p in (m.weight, m.bias):
                    if p is not None:
                        u = torch.rand(p.shape, generator=generator, dtype=torch.float32,
                                       device=generator.device)
                        p.copy_(u * (2 * bound) - bound)
            elif isinstance(m, _RMSNorm):
                m.scale.fill_(1.0)

    def rope(self, text_tokens: int, grid_h: int, grid_w: int, device) -> Tuple[Tensor, Tensor]:
        """(cos, sin) of the joint sequence, built once per resolution."""
        key = (text_tokens, grid_h, grid_w, torch.device(device))
        if key not in self._rope:
            ids = positions(text_tokens, grid_h, grid_w, device)
            self._rope[key] = rope_tables(ids, self.cfg.axes_dim, self.cfg.theta)
        return self._rope[key]

    def forward(self, x: Tensor, t: Tensor, *, dtype: torch.dtype = torch.float32,
                masters: bool = False, cond: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """Velocity v(x, t | cond) in ``dtype``. x: [B, H, W, C] NHWC latents;
        t: [B]; cond: ``txt`` [B, L, context_in_dim] and ``vec`` [B,
        vec_in_dim]."""
        if cond is None:
            raise ValueError("the flux backbone needs conditioning: cond={'txt': [B, L, "
                             f"{self.cfg.context_in_dim}], 'vec': [B, {self.cfg.vec_in_dim}]}}")
        cfg = self.cfg
        v = _View(self._params, dtype, masters)
        b, hh, ww, _ = x.shape
        p = cfg.patch_size
        txt, pooled = cond["txt"].to(dtype), cond["vec"].to(dtype)
        if txt.shape[0] != b or pooled.shape[0] != b:
            raise ValueError(f"cond rows {txt.shape[0]} / {pooled.shape[0]} against {b} latents")
        img = _dense(v, pack(x.to(dtype), p).contiguous(), self.img_in)
        txt = _dense(v, txt.contiguous(), self.txt_in)
        vec = self.time_in.embed(timestep_embedding(t).to(dtype), v)
        vec = vec + self.vector_in.embed(pooled, v)
        rope = self.rope(txt.shape[1], hh // p, ww // p, x.device)
        for blk in self.double_blocks:
            with annotate("rfv.flux.double"):
                img, txt = blk(img, txt, vec, v, cfg.num_heads, rope)
        tokens = torch.cat((txt, img), dim=1)
        for blk in self.single_blocks:
            with annotate("rfv.flux.single"):
                tokens = blk(tokens, vec, v, cfg.num_heads, rope)
        img = tokens[:, txt.shape[1]:]
        shift, scale = v.dense(P.silu(vec), self.final_layer.adaLN_modulation[1]).chunk(2, dim=-1)
        out = _dense(v, fused.ln_modulate(img, shift, scale), self.final_layer.linear)
        return unpack(out, x.shape, p)

"""FLUX.1 (Black Forest Labs; ``src/flux/model.py``, ``src/flux/modules/
layers.py`` of github.com/black-forest-labs/flux) velocity field in plain
PyTorch, for the benchmark's check.

The latents (NHWC) are packed 2 x 2 into tokens, channels in (c, ph, pw)
order. ``vec = time_in(emb(1000 t)) + vector_in(pooled)`` with emb the cos,
then sin, of 1000 t at 256 frequencies; every block takes (shift, scale,
gate) from ``lin(SiLU(vec))``. A double block runs text and image tokens
with weights of their own through affine-free LayerNorm (eps 1e-6), the
modulation, qkv, QK-RMSNorm (fp32 RMS, eps 1e-6, a learned scale a head
channel) and one softmax attention over cat(text, image), then each stream's
gated projection and gated GELU-tanh MLP; a single block runs one linear into
[qkv | MLP], the same attention, and one linear of cat(attention, GELU(MLP))
with one gate. RoPE: head channels (2j, 2j + 1) are one complex number,
multiplied by exp(i pos_a theta^(-2j' / d_a)) on the axis a that j falls in
(widths ``axes_dim``); text tokens sit at position 0, image tokens at (0,
row, col). The final layer is adaLN (shift, scale) and a linear on the image
tokens. Parameter names are the program's, which are the published model's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rfbench.reference.numerics import Numerics

Tensor = torch.Tensor


def layer_norm(x: Tensor) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def rms_norm(x: Tensor, scale: Tensor) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + 1e-6) * scale


def time_features(t: Tensor, dim: int = 256) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device).float() / half)
    arg = 1000.0 * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def rotation(txt: int, gh: int, gw: int, axes: List[int], theta: float, device) -> Tensor:
    """exp(i angle) [T, D / 2] (complex64) of the joint sequence."""
    rows = torch.arange(gh, device=device, dtype=torch.float64)
    cols = torch.arange(gw, device=device, dtype=torch.float64)
    pos = [torch.zeros(txt + gh * gw, device=device, dtype=torch.float64) for _ in axes]
    pos[1] = torch.cat([pos[1][:txt], rows[:, None].expand(gh, gw).reshape(-1)])
    pos[2] = torch.cat([pos[2][:txt], cols[None, :].expand(gh, gw).reshape(-1)])
    ang = torch.cat([p[:, None] * theta ** (-torch.arange(0, d, 2, device=device,
                                                           dtype=torch.float64) / d)[None]
                     for p, d in zip(pos, axes)], dim=-1)
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)


def apply_rotation(x: Tensor, rot: Optional[Tensor]) -> Tensor:
    """x [B, H, T, D]: adjacent channel pairs as complex numbers, times rot."""
    if rot is None:
        return x
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(z * rot).flatten(-2)


def attend(q: Tensor, k: Tensor, v: Tensor, num: Numerics) -> Tensor:
    """softmax(q k^T / sqrt(D)) v over [B, H, T, D]; -> [B, T, H D]."""
    att = torch.softmax(num.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), dim=-1)
    out = num.matmul(att, v)
    return out.transpose(1, 2).flatten(2)


def heads_of(qkv: Tensor, heads: int) -> Tuple[Tensor, Tensor, Tensor]:
    b, t, _ = qkv.shape
    return qkv.reshape(b, t, 3, heads, -1).permute(2, 0, 3, 1, 4).unbind(0)


class _Scale(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))


class _Norms(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.query_norm, self.key_norm = _Scale(d), _Scale(d)


class _Attn(nn.Module):
    def __init__(self, h: int, d: int, bias: bool) -> None:
        super().__init__()
        self.qkv = nn.Linear(h, 3 * h, bias=bias)
        self.norm = _Norms(d)
        self.proj = nn.Linear(h, h)


class _Lin(nn.Module):
    def __init__(self, h: int, n: int) -> None:
        super().__init__()
        self.lin = nn.Linear(h, n * h)


class _Embed(nn.Module):
    def __init__(self, n: int, h: int) -> None:
        super().__init__()
        self.in_layer, self.out_layer = nn.Linear(n, h), nn.Linear(h, h)

    def run(self, x: Tensor, num: Numerics) -> Tensor:
        y = F.silu(num.linear(x, self.in_layer.weight, self.in_layer.bias))
        return num.linear(y, self.out_layer.weight, self.out_layer.bias)


def _dense(x: Tensor, m: nn.Linear, num: Numerics) -> Tensor:
    if m.bias is None:
        return num.matmul(x, m.weight.t())
    return num.linear(x, m.weight, m.bias)


class Double(nn.Module):
    def __init__(self, h: int, heads: int, mlp: int, bias: bool) -> None:
        super().__init__()
        self.heads = heads
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", _Lin(h, 6))
            setattr(self, f"{s}_attn", _Attn(h, h // heads, bias))
            setattr(self, f"{s}_mlp", nn.Sequential(nn.Linear(h, mlp), nn.GELU("tanh"),
                                                    nn.Linear(mlp, h)))

    def run(self, img: Tensor, txt: Tensor, vec: Tensor, rot, num: Numerics):
        mods, qs, ks, vs = {}, [], [], []
        for s, x in (("txt", txt), ("img", img)):
            m = getattr(self, f"{s}_mod").lin
            mods[s] = num.linear(F.silu(vec), m.weight, m.bias)[:, None, :].chunk(6, dim=-1)
            shift, scale = mods[s][0], mods[s][1]
            a = getattr(self, f"{s}_attn")
            q, k, v = heads_of(_dense((1 + scale) * layer_norm(x) + shift, a.qkv, num), self.heads)
            qs.append(rms_norm(q, a.norm.query_norm.scale))
            ks.append(rms_norm(k, a.norm.key_norm.scale))
            vs.append(v)
        q, k = (apply_rotation(torch.cat(z, dim=2), rot) for z in (qs, ks))
        att = attend(q, k, torch.cat(vs, dim=2), num)
        out = []
        for s, x, a in (("txt", txt, att[:, :txt.shape[1]]), ("img", img, att[:, txt.shape[1]:])):
            _, _, g1, shift2, scale2, g2 = mods[s]
            proj = getattr(self, f"{s}_attn").proj
            x = x + g1 * num.linear(a, proj.weight, proj.bias)
            mlp = getattr(self, f"{s}_mlp")
            y = F.gelu(num.linear((1 + scale2) * layer_norm(x) + shift2, mlp[0].weight, mlp[0].bias),
                       approximate="tanh")
            out.append(x + g2 * num.linear(y, mlp[2].weight, mlp[2].bias))
        return out[1], out[0]


class Single(nn.Module):
    def __init__(self, h: int, heads: int, mlp: int) -> None:
        super().__init__()
        self.heads, self.h = heads, h
        self.linear1 = nn.Linear(h, 3 * h + mlp)
        self.linear2 = nn.Linear(h + mlp, h)
        self.norm = _Norms(h // heads)
        self.modulation = _Lin(h, 3)

    def run(self, x: Tensor, vec: Tensor, rot, num: Numerics) -> Tensor:
        m = self.modulation.lin
        shift, scale, gate = num.linear(F.silu(vec), m.weight, m.bias)[:, None, :].chunk(3, -1)
        y = num.linear((1 + scale) * layer_norm(x) + shift, self.linear1.weight, self.linear1.bias)
        q, k, v = heads_of(y[..., :3 * self.h], self.heads)
        q = apply_rotation(rms_norm(q, self.norm.query_norm.scale), rot)
        k = apply_rotation(rms_norm(k, self.norm.key_norm.scale), rot)
        cat = torch.cat([attend(q, k, v, num), F.gelu(y[..., 3 * self.h:], approximate="tanh")], -1)
        return x + gate * num.linear(cat, self.linear2.weight, self.linear2.bias)


class _Final(nn.Module):
    def __init__(self, h: int, out: int) -> None:
        super().__init__()
        self.linear = nn.Linear(h, out)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(h, 2 * h))


class Flux(nn.Module):
    def __init__(self, image_size: int = 128, in_channels: int = 16, patch_size: int = 2,
                 hidden_size: int = 3072, num_heads: int = 24, mlp_ratio: float = 4.0,
                 depth: int = 19, depth_single_blocks: int = 38, context_in_dim: int = 4096,
                 context_tokens: int = 256, vec_in_dim: int = 768, axes_dim=(16, 56, 56),
                 theta: int = 10000, qkv_bias: bool = True, **_) -> None:
        super().__init__()
        self.p, self.c, self.heads = patch_size, in_channels, num_heads
        self.ctx = (context_tokens, context_in_dim)
        self.vec_dim, self.axes, self.theta = vec_in_dim, list(axes_dim), theta
        h, mlp, tok = hidden_size, int(hidden_size * mlp_ratio), in_channels * patch_size**2
        self.img_in = nn.Linear(tok, h)
        self.time_in = _Embed(256, h)
        self.vector_in = _Embed(vec_in_dim, h)
        self.txt_in = nn.Linear(context_in_dim, h)
        self.double_blocks = nn.ModuleList(Double(h, num_heads, mlp, qkv_bias) for _ in range(depth))
        self.single_blocks = nn.ModuleList(Single(h, num_heads, mlp)
                                           for _ in range(depth_single_blocks))
        self.final_layer = _Final(h, tok)

    def velocity(self, x: Tensor, t: Tensor, num: Numerics, txt: Optional[Tensor] = None,
                 vec: Optional[Tensor] = None, rope: bool = True) -> Tensor:
        """NHWC latents -> NHWC velocity; ``txt`` / ``vec`` default to zeros
        of the configured shape (enough to count FLOPs); ``rope=False``
        leaves the rotation out (a planted fault)."""
        b, hh, ww, c = x.shape
        p = self.p
        if txt is None:
            txt = torch.zeros((b, *self.ctx), device=x.device)
        if vec is None:
            vec = torch.zeros((b, self.vec_dim), device=x.device)
        img = x.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 5, 2, 4)
        img = num.linear(img.reshape(b, (hh // p) * (ww // p), c * p * p), self.img_in.weight,
                         self.img_in.bias)
        cvec = self.time_in.run(time_features(t), num) + self.vector_in.run(vec.float(), num)
        txt = num.linear(txt.float(), self.txt_in.weight, self.txt_in.bias)
        rot = rotation(txt.shape[1], hh // p, ww // p, self.axes, self.theta, x.device) if rope \
            else None
        for blk in self.double_blocks:
            img, txt = blk.run(img, txt, cvec, rot, num)
        tokens = torch.cat([txt, img], dim=1)
        for blk in self.single_blocks:
            tokens = blk.run(tokens, cvec, rot, num)
        fin = self.final_layer
        shift, scale = num.linear(F.silu(cvec), fin.adaLN_modulation[1].weight,
                                  fin.adaLN_modulation[1].bias)[:, None, :].chunk(2, -1)
        out = num.linear((1 + scale) * layer_norm(tokens[:, txt.shape[1]:]) + shift,
                         fin.linear.weight, fin.linear.bias)
        out = out.reshape(b, hh // p, ww // p, c, p, p).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(b, hh, ww, c)


NETWORK = Flux


@torch.no_grad()
def serve(mods: Dict[str, nn.Module], noise: Tensor, txt: Tensor, vec: Tensor, steps: int,
          num: Numerics, block: int, rope: bool = True) -> Tensor:
    """Served images (NHWC, clipped) for NHWC ``noise`` and one prompt a
    row, ``block`` rows at a time: ``flow.serve``'s Euler loop and decode."""
    net, dec = mods["velocity_net"], mods.get("vae")
    out = []
    dt = float(np.float32(1.0 / steps))
    for x, tx, ve in zip(noise.split(block), txt.split(block), vec.split(block)):
        x = x.float()
        for i in range(steps):
            t = torch.full((x.shape[0],), float(np.float32(i) * np.float32(dt)), device=x.device)
            x = x + net.velocity(x, t, num, tx.float(), ve.float(), rope) * dt
        if dec is not None:
            x = dec.decode(x, num).clamp(-1.0, 1.0)
        out.append(x.clamp(-1.0, 1.0))
    return torch.cat(out)


def tokens(cfg: dict) -> Tuple[int, int]:
    """(text tokens, image tokens) of a forward."""
    return cfg["context_tokens"], (cfg["image_size"] // cfg["patch_size"]) ** 2


def flash_calls(cfg: dict, batch: int) -> list:
    """(B, T, H, D) of each joint attention in one forward."""
    t = sum(tokens(cfg))
    d = cfg["hidden_size"] // cfg["num_heads"]
    return [(batch, t, cfg["num_heads"], d)] * (cfg["depth"] + cfg["depth_single_blocks"])


def qk_norm_rope_sites(cfg: dict, batch: int) -> list:
    """(B, T_s, C, D) of each ``qk_norm_rope`` launch in one forward: a
    double block's text and image streams, a single block's joint one."""
    txt, img = tokens(cfg)
    c, d = cfg["hidden_size"], cfg["hidden_size"] // cfg["num_heads"]
    return ([(batch, txt, c, d), (batch, img, c, d)] * cfg["depth"]
            + [(batch, txt + img, c, d)] * cfg["depth_single_blocks"])


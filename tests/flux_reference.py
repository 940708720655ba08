"""A plain float32 FLUX (Black Forest Labs, FLUX.1) for the tier-1 tests of
the port's ``models/flux.py``.

Written from the published model's equations (``src/flux/model.py`` and
``src/flux/modules/layers.py`` of github.com/black-forest-labs/flux), in
plain ``torch`` with the published parameter names, so that the port's state
dict loads by name. Imports nothing of the port and no JAX; run it with TF32
off. It takes packed tokens and position ids as FLUX does:

    velocity(img [B, L_img, C p p], img_ids [B, L_img, 3], txt [B, L_txt, ctx],
             txt_ids [B, L_txt, 3], t [B], y [B, vec])

``rope=False`` leaves the rotary embedding out (a planted fault).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(t, dim, max_period=10000, time_factor=1000.0):
    t = time_factor * t
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(0, half, dtype=torch.float32) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope(pos, dim, theta):
    scale = torch.arange(0, dim, 2, dtype=torch.float64) / dim
    omega = 1.0 / (theta**scale)
    out = pos.double()[..., None] * omega  # [B, L, dim / 2]
    out = torch.stack([torch.cos(out), -torch.sin(out), torch.sin(out), torch.cos(out)], dim=-1)
    return out.reshape(*out.shape[:-1], 2, 2).float()


def embed_nd(ids, axes_dim, theta):
    emb = torch.cat([rope(ids[..., i], axes_dim[i], theta) for i in range(ids.shape[-1])], dim=-3)
    return emb.unsqueeze(1)  # [B, 1, L, D / 2, 2, 2]


def apply_rope(xq, xk, freqs_cis):
    xq_ = xq.float().reshape(*xq.shape[:-1], -1, 1, 2)
    xk_ = xk.float().reshape(*xk.shape[:-1], -1, 1, 2)
    xq_out = freqs_cis[..., 0] * xq_[..., 0] + freqs_cis[..., 1] * xq_[..., 1]
    xk_out = freqs_cis[..., 0] * xk_[..., 0] + freqs_cis[..., 1] * xk_[..., 1]
    return xq_out.reshape(*xq.shape).type_as(xq), xk_out.reshape(*xk.shape).type_as(xk)


def attention(q, k, v, pe):
    """q, k, v: [B, H, L, D]; pe None leaves RoPE out."""
    if pe is not None:
        q, k = apply_rope(q, k, pe)
    w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    x = w @ v
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim, hidden_dim):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden_dim, bias=True)
        self.out_layer = nn.Linear(hidden_dim, hidden_dim, bias=True)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        rrms = torch.rsqrt(torch.mean(x.float() ** 2, dim=-1, keepdim=True) + 1e-6)
        return x.float() * rrms * self.scale


class QKNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)


class SelfAttention(nn.Module):
    def __init__(self, dim, num_heads, qkv_bias):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.norm = QKNorm(dim // num_heads)
        self.proj = nn.Linear(dim, dim)


class Modulation(nn.Module):
    def __init__(self, dim, double):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = nn.Linear(dim, self.multiplier * dim, bias=True)

    def forward(self, vec):
        out = self.lin(F.silu(vec))[:, None, :].chunk(self.multiplier, dim=-1)
        return out[:3], out[3:]  # (shift, scale, gate) twice, or once


def _split_heads(qkv, heads):
    b, l, _ = qkv.shape
    return qkv.reshape(b, l, 3, heads, -1).permute(2, 0, 3, 1, 4)  # K B H L D


def _layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class DoubleStreamBlock(nn.Module):
    def __init__(self, hidden, heads, mlp_ratio, qkv_bias):
        super().__init__()
        mlp = int(hidden * mlp_ratio)
        self.num_heads = heads
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(hidden, double=True))
            setattr(self, f"{s}_attn", SelfAttention(hidden, heads, qkv_bias))
            setattr(self, f"{s}_mlp", nn.Sequential(nn.Linear(hidden, mlp), nn.GELU(approximate="tanh"),
                                                    nn.Linear(mlp, hidden)))

    def forward(self, img, txt, vec, pe):
        (i_shift1, i_scale1, i_gate1), (i_shift2, i_scale2, i_gate2) = self.img_mod(vec)
        (t_shift1, t_scale1, t_gate1), (t_shift2, t_scale2, t_gate2) = self.txt_mod(vec)
        iq, ik, iv = _split_heads(self.img_attn.qkv((1 + i_scale1) * _layer_norm(img) + i_shift1),
                                  self.num_heads)
        iq, ik = self.img_attn.norm.query_norm(iq), self.img_attn.norm.key_norm(ik)
        tq, tk, tv = _split_heads(self.txt_attn.qkv((1 + t_scale1) * _layer_norm(txt) + t_shift1),
                                  self.num_heads)
        tq, tk = self.txt_attn.norm.query_norm(tq), self.txt_attn.norm.key_norm(tk)
        attn = attention(torch.cat((tq, iq), 2), torch.cat((tk, ik), 2), torch.cat((tv, iv), 2), pe)
        t_attn, i_attn = attn[:, :txt.shape[1]], attn[:, txt.shape[1]:]
        img = img + i_gate1 * self.img_attn.proj(i_attn)
        img = img + i_gate2 * self.img_mlp((1 + i_scale2) * _layer_norm(img) + i_shift2)
        txt = txt + t_gate1 * self.txt_attn.proj(t_attn)
        txt = txt + t_gate2 * self.txt_mlp((1 + t_scale2) * _layer_norm(txt) + t_shift2)
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, hidden, heads, mlp_ratio):
        super().__init__()
        self.hidden, self.num_heads, self.mlp = hidden, heads, int(hidden * mlp_ratio)
        self.linear1 = nn.Linear(hidden, hidden * 3 + self.mlp)
        self.linear2 = nn.Linear(hidden + self.mlp, hidden)
        self.norm = QKNorm(hidden // heads)
        self.modulation = Modulation(hidden, double=False)

    def forward(self, x, vec, pe):
        (shift, scale, gate), _ = self.modulation(vec)
        qkv, mlp = torch.split(self.linear1((1 + scale) * _layer_norm(x) + shift),
                               [3 * self.hidden, self.mlp], dim=-1)
        q, k, v = _split_heads(qkv, self.num_heads)
        q, k = self.norm.query_norm(q), self.norm.key_norm(k)
        attn = attention(q, k, v, pe)
        return x + gate * self.linear2(torch.cat((attn, F.gelu(mlp, approximate="tanh")), 2))


class LastLayer(nn.Module):
    def __init__(self, hidden, out):
        super().__init__()
        self.linear = nn.Linear(hidden, out, bias=True)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 2 * hidden, bias=True))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=1)
        return self.linear((1 + scale[:, None, :]) * _layer_norm(x) + shift[:, None, :])


class Flux(nn.Module):
    def __init__(self, in_channels=64, vec_in_dim=768, context_in_dim=4096, hidden_size=3072,
                 mlp_ratio=4.0, num_heads=24, depth=19, depth_single_blocks=38,
                 axes_dim=(16, 56, 56), theta=10000, qkv_bias=True):
        super().__init__()
        self.axes_dim, self.theta = list(axes_dim), theta
        self.img_in = nn.Linear(in_channels, hidden_size, bias=True)
        self.time_in = MLPEmbedder(256, hidden_size)
        self.vector_in = MLPEmbedder(vec_in_dim, hidden_size)
        self.txt_in = nn.Linear(context_in_dim, hidden_size)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(hidden_size, num_heads, mlp_ratio, qkv_bias) for _ in range(depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth_single_blocks))
        self.final_layer = LastLayer(hidden_size, in_channels)

    def velocity(self, img, img_ids, txt, txt_ids, t, y, rope=True):
        img = self.img_in(img)
        vec = self.time_in(timestep_embedding(t, 256)) + self.vector_in(y)
        txt = self.txt_in(txt)
        pe = embed_nd(torch.cat((txt_ids, img_ids), dim=1), self.axes_dim, self.theta) if rope else None
        for block in self.double_blocks:
            img, txt = block(img, txt, vec, pe)
        x = torch.cat((txt, img), 1)
        for block in self.single_blocks:
            x = block(x, vec, pe)
        return self.final_layer(x[:, txt.shape[1]:], vec)


def pack(x_nhwc):
    """NHWC latents -> (tokens [B, h w / 4, 4 C] in (c, ph, pw) order, ids)."""
    b, h, w, c = x_nhwc.shape
    x = x_nhwc.permute(0, 3, 1, 2).reshape(b, c, h // 2, 2, w // 2, 2)
    tokens = x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)
    ids = torch.zeros(h // 2, w // 2, 3)
    ids[..., 1] = ids[..., 1] + torch.arange(h // 2)[:, None]
    ids[..., 2] = ids[..., 2] + torch.arange(w // 2)[None, :]
    return tokens, ids.reshape(1, -1, 3).repeat(b, 1, 1)


def unpack(tokens, shape):
    b, h, w, c = shape
    x = tokens.reshape(b, h // 2, w // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)

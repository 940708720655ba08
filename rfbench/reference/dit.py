"""DiT (Peebles & Xie, arXiv:2212.09748) velocity field in plain PyTorch.

adaLN-Zero blocks on patch tokens: a p x p patch conv, learned positions, a
time embedding (a 256-feature sinusoidal basis of t through two dense layers
with SiLU between), per block six modulation vectors regressed from
SiLU(c), affine-free LayerNorm (eps 1e-6), softmax self-attention over all
tokens, a tanh-GELU MLP, gated residuals, and a final adaLN + linear head
unpatchified to NHWC. Parameter names are the program's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rfbench.reference.numerics import Numerics
from rfbench.reference.unet import time_embedding

Tensor = torch.Tensor

TIME_BASIS = 256


def layer_norm(x: Tensor) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class Block(nn.Module):
    def __init__(self, hidden: int, mlp: int) -> None:
        super().__init__()
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)
        self.mlp1 = nn.Linear(hidden, mlp)
        self.mlp2 = nn.Linear(mlp, hidden)
        self.ada = nn.Linear(hidden, 6 * hidden)

    def run(self, x: Tensor, c: Tensor, heads: int, num: Numerics) -> Tensor:
        b, t, h = x.shape
        d = h // heads
        sm, cm, gm, sp, cp, gp = num.linear(F.silu(c), self.ada.weight, self.ada.bias).chunk(6, -1)
        qkv = num.linear(modulate(layer_norm(x), sm, cm), self.qkv.weight, self.qkv.bias)
        q, k, v = qkv.reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax(num.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        att = num.matmul(att, v).transpose(1, 2).reshape(b, t, h)
        x = x + gm[:, None, :] * num.linear(att, self.proj.weight, self.proj.bias)
        y = F.gelu(num.linear(modulate(layer_norm(x), sp, cp), self.mlp1.weight, self.mlp1.bias),
                   approximate="tanh")
        return x + gp[:, None, :] * num.linear(y, self.mlp2.weight, self.mlp2.bias)


class _TimeEmbed(nn.Module):
    def __init__(self, hidden: int) -> None:
        super().__init__()
        self.lin1 = nn.Linear(TIME_BASIS, hidden)
        self.lin2 = nn.Linear(hidden, hidden)


class _Final(nn.Module):
    def __init__(self, hidden: int, out: int) -> None:
        super().__init__()
        self.ada = nn.Linear(hidden, 2 * hidden)
        self.linear = nn.Linear(hidden, out)


class DiT(nn.Module):
    def __init__(self, image_size: int = 64, in_channels: int = 4, patch_size: int = 2,
                 hidden_size: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, **_) -> None:
        super().__init__()
        self.p, self.c, self.heads = patch_size, in_channels, num_heads
        tokens = (image_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden_size))
        self.t_embed = _TimeEmbed(hidden_size)
        self.blocks = nn.ModuleList(Block(hidden_size, int(hidden_size * mlp_ratio))
                                    for _ in range(depth))
        self.final = _Final(hidden_size, patch_size * patch_size * in_channels)

    def velocity(self, x: Tensor, t: Tensor, num: Numerics, seeds=None, image0: int = 0) -> Tensor:
        b, hh, ww, _ = x.shape
        p, h = self.p, self.pos_embed.shape[-1]
        tok = F.conv2d(num.q(x.permute(0, 3, 1, 2)), num.q(self.patch_embed.weight),
                       self.patch_embed.bias, stride=p)
        tok = tok.permute(0, 2, 3, 1).reshape(b, -1, h) + self.pos_embed
        c = num.linear(time_embedding(t, TIME_BASIS), self.t_embed.lin1.weight, self.t_embed.lin1.bias)
        c = num.linear(F.silu(c), self.t_embed.lin2.weight, self.t_embed.lin2.bias)
        for blk in self.blocks:
            tok = blk.run(tok, c, self.heads, num)
        shift, scale = num.linear(F.silu(c), self.final.ada.weight, self.final.ada.bias).chunk(2, -1)
        out = num.linear(modulate(layer_norm(tok), shift, scale), self.final.linear.weight,
                         self.final.linear.bias)
        out = out.reshape(b, hh // p, ww // p, p, p, self.c)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, self.c)


NETWORK = DiT


def flash_calls(cfg: dict, batch: int) -> list:
    """(B, T, H, D) of each attention call in one forward."""
    tokens = (cfg["image_size"] // cfg["patch_size"]) ** 2
    d = cfg["hidden_size"] // cfg["num_heads"]
    return [(batch, tokens, cfg["num_heads"], d)] * cfg["depth"]

"""The flagship UNet velocity field in plain PyTorch (NHWC activations).

The architecture of the repository's UNet (``configs/config.yaml``):
pre-activation residual blocks with an additive time projection, GroupNorm of
8 groups (eps 1e-5), SiLU, one skip saved per level before its stride-2
downsample and concatenated once on the way up, a nearest 2x upsample and a
3x3 conv per decoder level, 4-head softmax self-attention at the middle, and
a sinusoidal time embedding of ``channels`` features with frequencies
``exp(-ln(10000) i / (channels/2 - 1))``. Dropout sits between norm2 and
conv2 of every block; its mask is ``philox.dropout_factor`` of that block's
seed. The submodules exist for their parameters' names and shapes; the
forward pass is functional, every product through ``Numerics``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rfbench.reference import philox
from rfbench.reference.numerics import Numerics

Tensor = torch.Tensor


def group_norm(x: Tensor, m: nn.GroupNorm) -> Tensor:
    y = F.group_norm(x.permute(0, 3, 1, 2), m.num_groups, m.weight, m.bias, eps=1e-5)
    return y.permute(0, 2, 3, 1)


def time_embedding(t: Tensor, dim: int) -> Tensor:
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(i * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def upsample2x(x: Tensor) -> Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Block(nn.Module):
    def __init__(self, cin: int, cout: int, tdim: int, groups: int) -> None:
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_mlp = nn.Sequential(nn.SiLU(), nn.Linear(tdim, cout))
        self.norm2 = nn.GroupNorm(groups, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def run(self, x: Tensor, temb: Tensor, num: Numerics, drop: Optional[Tensor]) -> Tensor:
        h = num.conv(F.silu(group_norm(x, self.norm1)), self.conv1.weight, self.conv1.bias)
        lin = self.time_mlp[1]
        h = h + num.linear(F.silu(temb), lin.weight, lin.bias)[:, None, None, :]
        h = F.silu(group_norm(h, self.norm2))
        if drop is not None:
            h = h * drop
        h = num.conv(h, self.conv2.weight, self.conv2.bias)
        if self.shortcut is not None:
            x = num.conv(x, self.shortcut.weight, self.shortcut.bias)
        return h + x


class Attention(nn.Module):
    def __init__(self, ch: int, heads: int, groups: int) -> None:
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch)
        self.qkv = nn.Conv2d(ch, 3 * ch, 1)
        self.proj = nn.Conv2d(ch, ch, 1)
        self.heads = heads

    def run(self, x: Tensor, num: Numerics) -> Tensor:
        b, hh, ww, c = x.shape
        n, d = hh * ww, c // self.heads
        qkv = num.conv(group_norm(x, self.norm), self.qkv.weight, self.qkv.bias).reshape(b, n, 3 * c)
        q, k, v = (u.reshape(b, n, self.heads, d).transpose(1, 2) for u in qkv.split(c, dim=-1))
        att = torch.softmax(num.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        out = num.matmul(att, v).transpose(1, 2).reshape(b, hh, ww, c)
        return x + num.conv(out, self.proj.weight, self.proj.bias)


class UNet(nn.Module):
    def __init__(self, in_channels: int = 3, model_channels: int = 64,
                 channel_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 2,
                 dropout: float = 0.1, num_heads: int = 4, num_groups: int = 8, **_) -> None:
        super().__init__()
        self.ch, self.mult, self.nres, self.rate = model_channels, tuple(channel_mult), num_res_blocks, dropout
        chans = [model_channels * m for m in self.mult]
        tdim, g = 4 * model_channels, num_groups
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(model_channels, tdim), nn.SiLU(),
                                      nn.Linear(tdim, tdim))
        self.input_conv = nn.Conv2d(in_channels, model_channels, 3, padding=1)
        self.enc_blocks, self.downsamples = nn.ModuleList(), nn.ModuleList()
        ch = model_channels
        for lv, c in enumerate(chans):
            for _ in range(num_res_blocks):
                self.enc_blocks.append(Block(ch, c, tdim, g))
                ch = c
            if lv < len(chans) - 1:
                self.downsamples.append(nn.Conv2d(ch, ch, 3, stride=2, padding=1))
        self.mid_block1 = Block(ch, ch, tdim, g)
        self.mid_attn = Attention(ch, num_heads, g)
        self.mid_block2 = Block(ch, ch, tdim, g)
        self.dec_blocks, self.upsamples = nn.ModuleList(), nn.ModuleList()
        for lv in range(len(chans) - 1, -1, -1):
            self.dec_blocks.append(Block(ch + chans[lv], chans[lv], tdim, g))
            ch = chans[lv]
            for _ in range(1, num_res_blocks):
                self.dec_blocks.append(Block(ch, ch, tdim, g))
            if lv > 0:
                self.upsamples.append(nn.Sequential(nn.Upsample(scale_factor=2),
                                                    nn.Conv2d(ch, ch, 3, padding=1)))
        self.output_conv = nn.Sequential(nn.GroupNorm(g, chans[0]), nn.SiLU(),
                                         nn.Conv2d(chans[0], in_channels, 3, padding=1))

    @property
    def num_dropout_seeds(self) -> int:
        return len(self.enc_blocks) + 2 + len(self.dec_blocks)

    def velocity(self, x: Tensor, t: Tensor, num: Numerics, seeds: Optional[Tensor] = None,
                 image0: int = 0) -> Tensor:
        """v(x, t) for NHWC x; with ``seeds`` (one int32 per block, encoder,
        middle, decoder) the train step's dropout of images ``image0 ..``."""
        drops = iter(seeds.unbind(0) if seeds is not None and self.rate > 0
                     else [None] * self.num_dropout_seeds)

        def block(m: Block, h: Tensor) -> Tensor:
            seed = next(drops)
            b, hh, ww, _ = h.shape
            shape = (b, hh, ww, m.norm2.num_channels)
            mask = None if seed is None else philox.dropout_factor(shape, seed, self.rate, image0)
            return m.run(h, temb, num, mask)

        temb = time_embedding(t, self.ch)
        temb = num.linear(temb, self.time_mlp[1].weight, self.time_mlp[1].bias)
        temb = num.linear(F.silu(temb), self.time_mlp[3].weight, self.time_mlp[3].bias)
        h = num.conv(x, self.input_conv.weight, self.input_conv.bias)
        enc, skips = iter(self.enc_blocks), []  # type: ignore[var-annotated]
        for lv in range(len(self.mult)):
            for _ in range(self.nres):
                h = block(next(enc), h)
            skips.append(h)
            if lv < len(self.mult) - 1:
                d = self.downsamples[lv]
                h = num.conv(h, d.weight, d.bias, stride=2)
        h = block(self.mid_block1, h)
        h = self.mid_attn.run(h, num)
        h = block(self.mid_block2, h)
        dec, ups = iter(self.dec_blocks), iter(self.upsamples)
        for lv in range(len(self.mult) - 1, -1, -1):
            h = torch.cat([h, skips.pop()], dim=-1)
            for _ in range(self.nres):
                h = block(next(dec), h)
            if lv > 0:
                up = next(ups)[1]
                h = num.conv(upsample2x(h), up.weight, up.bias)
        h = F.silu(group_norm(h, self.output_conv[0]))
        return num.conv(h, self.output_conv[2].weight, self.output_conv[2].bias)


NETWORK = UNet


def kernel_sites(cfg: dict, batch: int) -> dict:
    """Shapes of the program's fused-kernel sites in one forward at
    ``batch``: ``conv3x3`` (B, H, W, Cin, Cout) at each block's conv1 / conv2
    and each upsample conv; ``gn_silu`` (B, H, W, C) at each block's norm1 and
    norm2 and at the head (eval), whose backward is ``gn_silu_backward``."""
    size, ch, mult, nres = cfg["image_size"], cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    chans = [ch * m for m in mult]
    conv: List[tuple] = []
    norm: List[tuple] = []

    def block(res: int, cin: int, cout: int) -> None:
        norm.extend([(batch, res, res, cin), (batch, res, res, cout)])
        conv.extend([(batch, res, res, cin, cout), (batch, res, res, cout, cout)])

    c, res, skips = ch, size, []
    for lv, cl in enumerate(chans):
        for _ in range(nres):
            block(res, c, cl)
            c = cl
        skips.append(c)
        if lv < len(chans) - 1:
            res //= 2
    block(res, c, c)
    block(res, c, c)
    for lv in range(len(chans) - 1, -1, -1):
        block(res, c + skips.pop(), chans[lv])
        c = chans[lv]
        for _ in range(1, nres):
            block(res, c, c)
        if lv > 0:
            res *= 2
            conv.append((batch, res, res, c, c))
    norm.append((batch, res, res, c))
    return {"conv3x3": conv, "gn_silu": norm}

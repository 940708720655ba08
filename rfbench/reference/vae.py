"""The decoder of the repository's ConvVAE (``configs/config_dit256.yaml``)
in plain PyTorch: a 3x3 conv from the latent channels, then per level
GroupNorm(8) + SiLU, a nearest 2x upsample and a 3x3 conv halving the
channels (not below the base), then GroupNorm + SiLU and a 3x3 conv to
pixels. The encoder's parameters are declared only so that the weights made
for both sides load into the program's whole module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rfbench.reference.numerics import Numerics
from rfbench.reference.unet import group_norm, upsample2x

Tensor = torch.Tensor


class _Level(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.norm = nn.GroupNorm(8, cin)


class ConvVAE(nn.Module):
    def __init__(self, in_channels: int = 3, latent_channels: int = 4, base_channels: int = 64,
                 downsample: int = 4, scaling_factor: float = 1.0, **_) -> None:
        super().__init__()
        levels, c = int(math.log2(downsample)), base_channels
        self.levels, self.scaling_factor = levels, scaling_factor
        enc = {"in": nn.Conv2d(in_channels, c, 3, padding=1)}
        ch = c
        for lv in range(levels):
            nxt = min(ch * 2, 4 * c)
            enc[f"down{lv}"] = _Level(ch, nxt, 2)
            ch = nxt
        enc["out_norm"] = nn.GroupNorm(8, ch)
        enc["out"] = nn.Conv2d(ch, 2 * latent_channels, 3, padding=1)
        dec = {"in": nn.Conv2d(latent_channels, ch, 3, padding=1)}
        for lv in range(levels):
            nxt = max(ch // 2, c)
            dec[f"up{lv}"] = _Level(ch, nxt, 1)
            ch = nxt
        dec["out_norm"] = nn.GroupNorm(8, ch)
        dec["out"] = nn.Conv2d(ch, in_channels, 3, padding=1)
        self.enc, self.dec = nn.ModuleDict(enc), nn.ModuleDict(dec)

    def decode(self, z: Tensor, num: Numerics) -> Tensor:
        """Scaled latents (NHWC) -> pixels (NHWC), not clipped."""
        d = self.dec
        h = num.conv(z / self.scaling_factor, d["in"].weight, d["in"].bias)
        for lv in range(self.levels):
            lev = d[f"up{lv}"]
            h = num.conv(upsample2x(F.silu(group_norm(h, lev.norm))), lev.conv.weight, lev.conv.bias)
        h = F.silu(group_norm(h, d["out_norm"]))
        return num.conv(h, d["out"].weight, d["out"].bias)

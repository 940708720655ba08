"""Weights of a cell, made from the seed on the device.

One normal draw of every parameter's elements at once, from a
``torch.Generator`` on the device, split and scaled by leaf: a conv or dense
weight by 1 / sqrt(fan_in), a GroupNorm scale as 1 + 0.05 z, every other
vector (biases, GroupNorm shifts) as 0.05 z, DiT's positions and its
zero-initialised adaLN projections and head as 0.02 z. Nothing is zero, so
no branch of the network is the zero function (a fresh DiT's is), and every
leaf gets a gradient.
"""

from __future__ import annotations

from typing import Dict

import torch

from rfbench import seeds
from rfbench.reference import flow

Tensor = torch.Tensor


def _scale(name: str, shape: torch.Size, norm_scales: set) -> tuple:
    """(offset, scale): the leaf is offset + scale * z."""
    if name.endswith("pos_embed") or ".ada." in f".{name}" or name.startswith("final.linear"):
        return 0.0, 0.02
    if name in norm_scales:
        return 1.0, 0.05
    if len(shape) == 1:
        return 0.0, 0.05
    return 0.0, shape[1:].numel() ** -0.5


def make(config: dict, seed: int, device) -> Dict[str, Dict[str, Tensor]]:
    """float32 weights by module (``velocity_net``, ``vae``), then state-dict
    name, for the reference's modules and the program's alike."""
    mods = flow.skeleton(config)
    shapes = [(mod, name, p.shape) for mod, m in mods.items() for name, p in m.named_parameters()]
    norm_scales = {f"{name}.weight" for m in mods.values() for name, sub in m.named_modules()
                   if isinstance(sub, torch.nn.GroupNorm)}
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    total = sum(s.numel() for _, _, s in shapes)
    z = torch.randn((total,), generator=gen, dtype=torch.float32, device=device)
    out: Dict[str, Dict[str, Tensor]] = {}
    for (mod, name, shape), part in zip(shapes, z.split([s.numel() for _, _, s in shapes])):
        offset, scale = _scale(name, shape, norm_scales)
        out.setdefault(mod, {})[name] = part.view(shape).mul_(scale).add_(offset)
    return out

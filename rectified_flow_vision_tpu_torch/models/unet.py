"""UNet velocity-field backbone as an ``nn.Module`` (NHWC at the public call).

Counterpart of the JAX package's ``models/unet.py``: the same architecture,
the same rounding points, and the reference module names, so that a state
dict from ``utils.pt_import.params_to_state_dict`` (or a reference ``.pt``)
loads with ``strict=True``:

    time_mlp.{1,3}                     Linear layers of the time MLP
    input_conv                         3x3 conv
    enc_blocks.{i}                     flat list of residual blocks
    downsamples.{level}                3x3 / stride-2 convs
    mid_block1, mid_attn, mid_block2   mid_attn.qkv / .proj are 1x1 convs
    dec_blocks.{i}
    upsamples.{j}.1                    Sequential(Upsample, Conv)
    output_conv.{0,2}                  Sequential(GroupNorm, SiLU, Conv)

The default config has 11,255,363 parameters. Parameters are kept in fp32
with torch layouts (conv OIHW, Linear (out, in)). ``forward(x, t, dtype=)``
computes in ``dtype`` with parameters rounded to it first, as the JAX
sampler casts its param tree; the rounded copies, and the conv3x3 weights
repacked to ``(Cout, 3, 3, Cin)``, are cached per parameter and dtype and
rebuilt when a parameter changes (``_ParamCache``), not repacked per call.

Kernel sites (``ops/fused.py``) are the JAX package's: ``gn_silu`` at each
block's norm1 and norm2 (eval) and at the head, ``conv3x3`` at conv1, conv2
and the upsample convs, ``attention_block`` at ``mid_attn``. The input and
output convs, the stride-2 downsamples and the 1x1 shortcuts are plain
convs, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import primitives as P

Tensor = torch.Tensor


class _ParamCache:
    """Copies of parameters in a compute dtype and kernel layout.

    Layouts: ``plain`` (the parameter rounded to ``dtype``), ``f32`` (rounded
    to ``dtype``, then widened to fp32: biases and norm parameters, which the
    kernels take in fp32), ``ohwi`` (a conv weight permuted to
    ``(Cout, kh, kw, Cin)``, the conv3x3 kernel's layout) and ``mat`` (a 1x1
    conv weight as a ``(Cout, Cin)`` matrix). An entry is rebuilt when its
    parameter's storage or version counter changes (``load_state_dict``,
    ``.to(device)``, an in-place update).
    """

    def __init__(self) -> None:
        self._store: Dict[Tuple[int, torch.dtype, str], Tuple[tuple, Tensor]] = {}

    def get(self, p: Tensor, dtype: torch.dtype, layout: str = "plain") -> Tensor:
        key = (id(p), dtype, layout)
        stamp = (p.data_ptr(), p._version, p.device)
        hit = self._store.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        with torch.no_grad():
            t = p.detach().to(dtype)
            if layout == "f32":
                t = t.float()
            elif layout == "ohwi":
                t = t.permute(0, 2, 3, 1).contiguous()
            elif layout == "mat":
                t = t.reshape(t.shape[0], -1).contiguous()
            elif layout != "plain":
                raise ValueError(f"unknown layout {layout!r}")
        self._store[key] = (stamp, t)
        return t


class _View:
    """The parameters of one forward call, in that call's dtype."""

    def __init__(self, cache: _ParamCache, dtype: torch.dtype) -> None:
        self.cache, self.dtype = cache, dtype

    def __call__(self, p: Tensor, layout: str = "plain") -> Tensor:
        return self.cache.get(p, self.dtype, layout)

    def conv(self, x: Tensor, m: nn.Conv2d) -> Tensor:
        """A conv the JAX package leaves to XLA: plain, any device."""
        return P.conv2d(x, self(m.weight), self(m.bias, "f32"), stride=m.stride[0])

    def conv3x3(self, x: Tensor, m: nn.Conv2d) -> Tensor:
        """A conv3x3 kernel site (``fused.conv2d_fused``)."""
        return fused.conv2d_fused(x, self(m.weight, "ohwi"), self(m.bias, "f32"))

    def gn_silu(self, x: Tensor, m: nn.GroupNorm) -> Tensor:
        return fused.gn_silu(
            x, self(m.weight, "f32"), self(m.bias, "f32"), num_groups=m.num_groups
        )

    def dense(self, x: Tensor, m: nn.Linear) -> Tensor:
        return P.dense(x, self(m.weight), self(m.bias, "f32"))


class ResidualBlock(nn.Module):
    """Pre-activation residual block with additive time conditioning.

    h = conv1(silu(gn(x))); h += Linear(silu(t_emb)); h = conv2(dropout(
    silu(gn(h)))); return h + shortcut(x).
    """

    def __init__(
        self, in_ch: int, out_ch: int, time_dim: int, dropout: float, num_groups: int
    ) -> None:
        super().__init__()
        self.norm1 = nn.GroupNorm(num_groups, in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_dim, out_ch))
        self.norm2 = nn.GroupNorm(num_groups, out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        self.dropout = dropout

    def forward(self, x: Tensor, t_emb: Tensor, v: _View) -> Tensor:
        h = v.gn_silu(x, self.norm1)
        h = v.conv3x3(h, self.conv1)
        t_bias = v.dense(P.silu(t_emb), self.time_mlp[1])
        h = h + t_bias[:, None, None, :].to(h.dtype)
        # eval: gn -> silu -> dropout is gn_silu (training dropout comes
        # with the training slice)
        h = P.dropout(v.gn_silu(h, self.norm2), self.dropout, train=False)
        h = v.conv3x3(h, self.conv2)
        shortcut = v.conv(x, self.shortcut) if self.shortcut is not None else x
        return h + shortcut


class AttentionBlock(nn.Module):
    """Mid-block spatial self-attention; qkv / proj are 1x1 convs as in the
    reference, applied as dense layers over the channel axis."""

    def __init__(self, ch: int, num_heads: int, num_groups: int) -> None:
        super().__init__()
        self.norm = nn.GroupNorm(num_groups, ch)
        self.qkv = nn.Conv2d(ch, ch * 3, 1)
        self.proj = nn.Conv2d(ch, ch, 1)
        self.num_heads = num_heads

    def forward(self, x: Tensor, v: _View) -> Tensor:
        return fused.attention(
            x,
            v(self.norm.weight, "f32"),
            v(self.norm.bias, "f32"),
            v(self.qkv.weight, "mat"),
            v(self.qkv.bias, "f32"),
            v(self.proj.weight, "mat"),
            v(self.proj.bias, "f32"),
            num_heads=self.num_heads,
            num_groups=self.norm.num_groups,
        )


class UNet(nn.Module):
    """UNet velocity field: ``unet(x, t, dtype=...)`` with x NHWC, t [B] in [0, 1]."""

    def __init__(
        self,
        in_channels: int = 3,
        model_channels: int = 64,
        out_channels: int = 3,
        channel_mult: Sequence[int] = (1, 2, 4),
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (16, 8),
        dropout: float = 0.1,
        num_heads: int = 4,
        num_groups: int = 8,
    ) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.out_channels = out_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        # accepted for config parity; as in the reference, attention runs
        # only at the middle block
        self.attention_resolutions = tuple(attention_resolutions)
        self.dropout = dropout
        chans = [model_channels * m for m in self.channel_mult]
        tdim = model_channels * 4
        levels = len(chans)

        self.time_mlp = nn.Sequential(
            nn.Identity(),  # the sinusoidal embedding, computed in forward
            nn.Linear(model_channels, tdim),
            nn.SiLU(),
            nn.Linear(tdim, tdim),
        )
        self.input_conv = nn.Conv2d(in_channels, model_channels, 3, padding=1)

        def block(i: int, o: int) -> ResidualBlock:
            return ResidualBlock(i, o, tdim, dropout, num_groups)

        self.enc_blocks = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        ch = model_channels
        for level in range(levels):
            for _ in range(num_res_blocks):
                self.enc_blocks.append(block(ch, chans[level]))
                ch = chans[level]
            if level < levels - 1:
                self.downsamples.append(nn.Conv2d(ch, ch, 3, stride=2, padding=1))

        self.mid_block1 = block(ch, ch)
        self.mid_attn = AttentionBlock(ch, num_heads, num_groups)
        self.mid_block2 = block(ch, ch)

        self.dec_blocks = nn.ModuleList()
        self.upsamples = nn.ModuleList()
        for level in range(levels - 1, -1, -1):
            self.dec_blocks.append(block(ch + chans[level], chans[level]))
            ch = chans[level]
            for _ in range(1, num_res_blocks):
                self.dec_blocks.append(block(ch, ch))
            if level > 0:
                self.upsamples.append(
                    nn.Sequential(
                        nn.Upsample(scale_factor=2, mode="nearest"),
                        nn.Conv2d(ch, ch, 3, padding=1),
                    )
                )

        self.output_conv = nn.Sequential(
            nn.GroupNorm(num_groups, chans[0]),
            nn.SiLU(),
            nn.Conv2d(chans[0], out_channels, 3, padding=1),
        )
        self._params = _ParamCache()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Torch-default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for conv and
        Linear weights and biases, ones/zeros for GroupNorm, drawn in module
        order from ``generator`` (on the CPU, so a seed gives the same weights
        on every device)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                    p.copy_(u * (2 * bound) - bound)
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)

    def forward(self, x: Tensor, t: Tensor, *, dtype: torch.dtype = torch.float32) -> Tensor:
        """Velocity v(x, t) in ``dtype``. x: [B, H, W, C] NHWC; t: [B]."""
        v = _View(self._params, dtype)
        x = x.to(dtype)

        t_emb = P.sinusoidal_time_embedding(t, self.model_channels).to(dtype)
        t_emb = v.dense(t_emb, self.time_mlp[1])
        t_emb = v.dense(P.silu(t_emb), self.time_mlp[3])

        h = v.conv(x, self.input_conv)
        levels = len(self.channel_mult)
        blocks = iter(self.enc_blocks)
        skips: List[Tensor] = []
        for level in range(levels):
            for _ in range(self.num_res_blocks):
                h = next(blocks)(h, t_emb, v)
            skips.append(h)  # saved before the downsample
            if level < levels - 1:
                h = v.conv(h, self.downsamples[level])

        h = self.mid_block1(h, t_emb, v)
        h = self.mid_attn(h, v)
        h = self.mid_block2(h, t_emb, v)

        blocks = iter(self.dec_blocks)
        ups = iter(self.upsamples)
        for level in range(levels - 1, -1, -1):
            h = torch.cat([h, skips.pop().to(h.dtype)], dim=-1)
            for _ in range(self.num_res_blocks):
                h = next(blocks)(h, t_emb, v)
            if level > 0:
                h = P.upsample_nearest_2x(h)
                h = v.conv3x3(h, next(ups)[1])

        h = v.gn_silu(h, self.output_conv[0])
        return v.conv(h, self.output_conv[2])


def count_parameters(module: nn.Module) -> int:
    """Total trainable parameter count."""
    return int(sum(p.numel() for p in module.parameters()))

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
computes in ``dtype`` and sees the parameters in one of two ways:

* sampling (the default): every parameter is rounded to ``dtype`` first, as
  the JAX sampler casts its param tree; the rounded copies, and the conv3x3
  weights repacked to ``(Cout, 3, 3, Cin)``, are detached, cached per
  parameter and dtype and rebuilt when a parameter changes (``_ParamCache``);
* ``masters=True`` (the loss): the fp32 masters stay in the autograd graph,
  as in the JAX train step. Weights are cast to ``dtype`` per op, biases and
  norm parameters go to the kernels in fp32 unrounded, nothing is cached.

Kernel sites (``ops/fused.py``) are the JAX package's: ``gn_silu`` at each
block's norm1 and at the head, ``gn_silu_dropout`` at norm2 (``gn_silu`` in
eval mode), ``conv3x3`` at conv1, conv2 and the upsample convs,
``attention_block`` at ``mid_attn``. The input and output convs, the
stride-2 downsamples and the 1x1 shortcuts are plain convs, as the JAX
package leaves them to XLA.

Tensor parallelism (``parallel/mesh.py`` ``shard_params`` sets ``tp``): each
rank holds its shards of the parameters that ``_TP_RULES`` splits, and the
forward is Megatron's. A residual block's conv1 and time projection are
column-parallel (the rank's out channels), norm2 runs the fused kernel on
those channels with 8 / tp groups and the dropout mask of their place in the
whole activation, conv2 is row-parallel: the ranks' partial sums are summed
over the group and the bias added once. The attention block runs its kernels
on the rank's heads without the residual, summed the same way; the time MLP
splits its 4C hidden dim. ``copy_to_group`` / ``psum``
(``parallel/collectives.py``) carry the gradients across the group.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import primitives as P
from rectified_flow_vision_tpu_torch.parallel import collectives

Tensor = torch.Tensor


def _layout(p: Tensor, dtype: torch.dtype, layout: str, round_f32: bool) -> Tensor:
    """``p`` in ``dtype`` and a kernel layout (see ``_ParamCache``)."""
    if layout == "f32":
        return p.to(dtype).float() if round_f32 else p.float()
    t = p.to(dtype)
    if layout == "ohwi":
        return t.permute(0, 2, 3, 1).contiguous()
    if layout == "mat":
        return t.reshape(t.shape[0], -1).contiguous()
    if layout != "plain":
        raise ValueError(f"unknown layout {layout!r}")
    return t


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
            t = _layout(p.detach(), dtype, layout, round_f32=True)
        self._store[key] = (stamp, t)
        return t


class _View:
    """The parameters of one forward call, in that call's dtype: cached,
    rounded and detached copies for sampling, or (``masters``) the fp32
    masters cast inside the autograd graph; with ``tp`` (a
    ``parallel.mesh.TensorParallel``) the rank's shards of them. With
    ``sum_grads`` (a process group whose ranks each hold part of the tokens)
    the masters' gradients are summed over it."""

    def __init__(
        self, cache: _ParamCache, dtype: torch.dtype, masters: bool = False, tp=None,
        sum_grads=None,
    ) -> None:
        self.cache, self.dtype, self.masters, self.tp = cache, dtype, masters, tp
        self.sum_grads = sum_grads

    def __call__(self, p: Tensor, layout: str = "plain") -> Tensor:
        if self.masters:
            if self.sum_grads is not None:
                p = collectives.copy_to_group(p, self.sum_grads)
            return _layout(p, self.dtype, layout, round_f32=False)
        return self.cache.get(p, self.dtype, layout)

    def conv(self, x: Tensor, m: nn.Conv2d) -> Tensor:
        """A conv the JAX package leaves to XLA: plain, any device."""
        return P.conv2d(x, self(m.weight), self(m.bias, "f32"), stride=m.stride[0])

    def conv3x3(self, x: Tensor, m: nn.Conv2d) -> Tensor:
        """A conv through ``fused.conv2d_fused``: the conv3x3 kernel inside its
        contract, the plain conv outside it."""
        return fused.conv2d_fused(x, self(m.weight, "ohwi"), self(m.bias, "f32"),
                                  stride=m.stride[0])

    def col_conv3x3(self, x: Tensor, m: nn.Conv2d) -> Tensor:
        """A conv3x3 site that is column-parallel under tensor parallelism
        (the rank's output channels)."""
        if self.tp is None:
            return self.conv3x3(x, m)
        return fused.conv2d_fused(x, self(m.weight, "ohwi"), self(m.bias, "f32"),
                                  shards=(1, self.tp.size))

    def gn_silu(self, x: Tensor, m: nn.GroupNorm) -> Tensor:
        return fused.gn_silu(
            x, self(m.weight, "f32"), self(m.bias, "f32"), num_groups=m.num_groups
        )

    def gn_silu_dropout(
        self, x: Tensor, m: nn.GroupNorm, rate: float, seed: Optional[Tensor], train: bool
    ) -> Tensor:
        groups, channels = m.num_groups, None
        if self.tp is not None:  # this rank's channels: their groups, their mask bits
            c = x.shape[-1]
            groups, channels = groups // self.tp.size, (self.tp.rank * c, self.tp.size * c)
        return fused.gn_silu_dropout(
            x, self(m.weight, "f32"), self(m.bias, "f32"), rate, seed,
            train=train, num_groups=groups, channels=channels,
        )

    def dense(self, x: Tensor, m: nn.Linear) -> Tensor:
        return P.dense(x, self(m.weight), self(m.bias, "f32"))

    # ---- tensor parallelism (the identity without ``tp``) ----

    def to_tp(self, x: Tensor) -> Tensor:
        """A value every rank holds, entering column-parallel work."""
        return x if self.tp is None else collectives.copy_to_group(x, self.tp.group)

    def tp_sum(self, part: Tensor, bias: Tensor) -> Tensor:
        """Row-parallel partial sums (bias-free), summed over the group in
        fp32, then the bias added once and rounded to the part's dtype."""
        return (collectives.psum(part.float(), self.tp.group) + bias).to(part.dtype)

    def row_conv3x3(self, x: Tensor, m: nn.Conv2d) -> Tensor:
        """A conv3x3 site that is row-parallel under tensor parallelism."""
        if self.tp is None:
            return self.conv3x3(x, m)
        bias = self(m.bias, "f32")
        part = fused.conv2d_fused(x, self(m.weight, "ohwi"), torch.zeros_like(bias),
                                  shards=(self.tp.size, 1))
        return self.tp_sum(part, bias)

    def row_dense(self, x: Tensor, m: nn.Linear) -> Tensor:
        """A dense layer that is row-parallel under tensor parallelism."""
        if self.tp is None:
            return self.dense(x, m)
        bias = self(m.bias, "f32")
        return self.tp_sum(P.dense(x, self(m.weight), torch.zeros_like(bias)), bias)


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

    def forward(
        self, x: Tensor, t_emb: Tensor, v: _View, seed: Optional[Tensor] = None,
        train: bool = False,
    ) -> Tensor:
        h = v.to_tp(v.gn_silu(x, self.norm1))
        h = v.col_conv3x3(h, self.conv1)
        t_bias = v.dense(v.to_tp(P.silu(t_emb)), self.time_mlp[1])
        h = h + t_bias[:, None, None, :].to(h.dtype)
        # gn -> silu -> dropout is one fused pass; gn_silu in eval mode
        h = v.gn_silu_dropout(h, self.norm2, self.dropout, seed, train)
        h = v.row_conv3x3(h, self.conv2)
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
        weights = (
            v(self.norm.weight, "f32"),
            v(self.norm.bias, "f32"),
            v(self.qkv.weight, "mat"),
            v(self.qkv.bias, "f32"),
            v(self.proj.weight, "mat"),
        )
        bias = v(self.proj.bias, "f32")
        if v.tp is None:
            return fused.attention(
                x, *weights, bias, num_heads=self.num_heads, num_groups=self.norm.num_groups
            )
        # the rank's heads, without the residual; their sum, the bias once,
        # +x. x and the norm's affine, which every rank holds, feed
        # rank-local work: their gradients are summed over the group.
        ns, nb, *split = weights
        part = fused.attention(
            v.to_tp(x), v.to_tp(ns), v.to_tp(nb), *split, torch.zeros_like(bias),
            num_heads=self.num_heads // v.tp.size, num_groups=self.norm.num_groups,
            residual=False,
        )
        return x + v.tp_sum(part, bias)


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
        self.norm_groups = num_groups
        self.tp = None  # a parallel.mesh.TensorParallel once shard_params splits the weights
        self.fsdp = False
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

    @property
    def num_dropout_seeds(self) -> int:
        """One dropout seed per residual block: encoder, middle, decoder."""
        return 2 * len(self.channel_mult) * self.num_res_blocks + 2

    def forward(
        self,
        x: Tensor,
        t: Tensor,
        *,
        dtype: torch.dtype = torch.float32,
        train: bool = False,
        seeds: Optional[Tensor] = None,
        masters: bool = False,
        remat: bool = False,
    ) -> Tensor:
        """Velocity v(x, t) in ``dtype``. x: [B, H, W, C] NHWC; t: [B].

        With ``train`` and ``seeds`` (``num_dropout_seeds`` int32 values on
        x's device, one per residual block in the order encoder, middle,
        decoder) each block's norm2 drops activations at rate ``dropout``.
        ``masters`` keeps the fp32 parameters in the autograd graph (see the
        module docstring). ``remat`` recomputes each residual block in the
        backward pass instead of keeping its activations: a memory lever; the
        seed makes the recomputed mask the same.
        """
        v = _View(self._params, dtype, masters, self.tp)
        x = x.to(dtype)
        if train and seeds is not None and self.dropout > 0:
            if tuple(seeds.shape) != (self.num_dropout_seeds,) or seeds.dtype != torch.int32:
                raise ValueError(
                    f"seeds must be {self.num_dropout_seeds} int32 values, got "
                    f"{tuple(seeds.shape)} {seeds.dtype}"
                )
            seed_it = iter(seeds[i : i + 1] for i in range(self.num_dropout_seeds))
        else:
            seed_it = iter([None] * self.num_dropout_seeds)

        def res(block: ResidualBlock, h: Tensor) -> Tensor:
            seed = next(seed_it)
            if remat:
                return checkpoint(
                    block, h, t_emb, v, seed, train, use_reentrant=False,
                    preserve_rng_state=False,
                )
            return block(h, t_emb, v, seed, train)

        t_emb = P.sinusoidal_time_embedding(t, self.model_channels).to(dtype)
        t_emb = v.dense(v.to_tp(t_emb), self.time_mlp[1])
        t_emb = v.row_dense(P.silu(t_emb), self.time_mlp[3])

        h = v.conv(x, self.input_conv)
        levels = len(self.channel_mult)
        blocks = iter(self.enc_blocks)
        skips: List[Tensor] = []
        for level in range(levels):
            for _ in range(self.num_res_blocks):
                h = res(next(blocks), h)
            skips.append(h)  # saved before the downsample
            if level < levels - 1:
                h = v.conv(h, self.downsamples[level])

        h = res(self.mid_block1, h)
        h = self.mid_attn(h, v)
        h = res(self.mid_block2, h)

        blocks = iter(self.dec_blocks)
        ups = iter(self.upsamples)
        for level in range(levels - 1, -1, -1):
            h = torch.cat([h, skips.pop().to(h.dtype)], dim=-1)
            for _ in range(self.num_res_blocks):
                h = res(next(blocks), h)
            if level > 0:
                h = P.upsample_nearest_2x(h)
                h = v.conv3x3(h, next(ups)[1])

        h = v.gn_silu(h, self.output_conv[0])
        return v.conv(h, self.output_conv[2])


def count_parameters(module: nn.Module) -> int:
    """Total trainable parameter count."""
    return int(sum(p.numel() for p in module.parameters()))

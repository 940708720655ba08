"""DiT (Diffusion Transformer) velocity-field backbone as an ``nn.Module``.

Counterpart of the JAX package's ``models/dit.py``: the DiT architecture
(Peebles & Xie, 2023) as a flow-matching velocity field, with the same
rounding points and the JAX param tree's names, so that a ``.npz`` written by
either package loads into the other (``utils.pt_import.tree_to_state_dict``):

    patch_embed                       patch x patch conv, stride = patch
    pos_embed                         learned, a bare (1, T, hidden) parameter
    t_embed.{lin1,lin2}               MLP on a 256-dim sinusoidal basis of t
    blocks.{i}.{qkv,proj,mlp1,mlp2}   pre-LN transformer block
    blocks.{i}.ada                    adaLN-Zero: 6 x hidden modulation from t
    final.{ada,linear}                final adaLN + zero-initialised head

Every block's LayerNorms are affine-free and modulated by (shift, scale,
gate) regressed from the time embedding through zero-initialised projections,
so a fresh network is the zero function.

The passes between a block's GEMMs are ``ops.fused``'s ``ln_modulate``
(every LayerNorm + modulate, the head's too), ``bias_act`` (the qkv and mlp1
epilogues, GELU in mlp1's) and ``gated_residual`` (the proj and mlp2
epilogues with their gate and the residual add); the GEMMs stay
``torch.matmul``. On a CUDA tensor the hand-written kernels
(``ops/dit_glue.py``) run in every forward, the loss's and the one ``remat``
reruns included; the backward differentiates the eager composition of
``ops/primitives.py``, since the kernels have no backward yet. Under tensor
parallelism the proj and mlp2 sites stay the eager composition, their
row-parallel bias added after the psum.

Attention is ``ops.fused.flash_attention``: the hand-written flash kernels
(forward, and dq / dkv in the backward) for sequences of at least 1024 tokens
that are a multiple of 128, the plain attention below that, as the JAX
package dispatches. ``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), which reruns the forward kernel there.

Parameters are fp32 with torch layouts; ``forward(x, t, dtype=)`` sees them
as ``models.unet`` describes: rounded, detached, cached copies for sampling,
or (``masters=True``) the fp32 masters inside the autograd graph.

Sequence parallelism (``forward(mesh=, seq_axis=)``): each rank of the
mesh's ``seq_axis`` keeps its slice of the tokens after the patch embedding
(its ``pos_embed`` rows with them), the blocks run on it with ring attention
(``parallel/ring_attention.py``) in place of flash, and an all-gather with
its gradient at the head returns the whole output on every rank; the
masters' gradients are summed over the ranks. ``pipeline_apply`` is the
GPipe forward over a ``stage`` axis (``parallel/pipeline.py``). Tensor
parallelism (``parallel/mesh.py`` ``shard_params``) splits each block's
heads and MLP columns (``DiTBlock``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rectified_flow_vision_tpu_torch.models.unet import _ParamCache, _View
from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import primitives as P
from rectified_flow_vision_tpu_torch.parallel import collectives

Tensor = torch.Tensor

TIME_BASIS = 256  # width of the sinusoidal basis, as DiT's TimestepEmbedder


@dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 384  # DiT-S
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    # recompute each block in the backward pass instead of keeping its
    # attention / MLP activations
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def out_channels(self) -> int:
        return self.in_channels


# DiT size table (hidden, depth, heads)
DIT_SIZES = {
    "S": (384, 12, 6),
    "B": (768, 12, 12),
    "L": (1024, 24, 16),
    "XL": (1152, 28, 16),
}


def _matmul(x: Tensor, w: Tensor) -> Tensor:
    """A dense layer's GEMM alone: ``P.dense`` without its bias."""
    return torch.matmul(x, w.to(x.dtype).t())


def _dense(v: _View, x: Tensor, m: nn.Linear, act: Optional[str] = None) -> Tensor:
    """A column-parallel dense layer, then ``act``."""
    return fused.bias_act(_matmul(x, v(m.weight)), v(m.bias, "f32"), act)


def _gated_row_dense(v: _View, tokens: Tensor, x: Tensor, m: nn.Linear, gate: Tensor) -> Tensor:
    """tokens + gate * (a row-parallel dense layer of x); under tensor
    parallelism the eager composition, the bias added after the psum."""
    if v.tp is not None:
        return tokens + gate[:, None, :] * v.row_dense(x, m)
    return fused.gated_residual(tokens, _matmul(x, v(m.weight)), v(m.bias, "f32"), gate)


class DiTBlock(nn.Module):
    """One adaLN-Zero DiT block: tokens [B, T, C], c_emb [B, C] -> [B, T, C]
    (the JAX package's ``block_apply``). With ``seq_group`` the tokens are
    this rank's slice and attention is the ring over the group. Under tensor
    parallelism (``v.tp``) qkv and mlp1 are column-parallel (the rank's heads
    and hidden columns), proj and mlp2 row-parallel, summed over the group
    with the bias added once; adaLN stays whole."""

    def __init__(self, hidden: int, mlp_dim: int) -> None:
        super().__init__()
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)
        self.mlp1 = nn.Linear(hidden, mlp_dim)
        self.mlp2 = nn.Linear(mlp_dim, hidden)
        self.ada = nn.Linear(hidden, 6 * hidden)

    def forward(
        self, tokens: Tensor, c_emb: Tensor, v: _View, num_heads: int, seq_group=None
    ) -> Tensor:
        b, t, hidden = tokens.shape
        hd = hidden // num_heads
        if v.tp is not None:  # this rank's heads and MLP columns
            num_heads //= v.tp.size
        mod = v.dense(P.silu(c_emb), self.ada)  # [B, 6C]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        # attention branch: q, k, v are views of the one projection
        hmod = v.to_tp(fused.ln_modulate(tokens, shift_msa, scale_msa))
        q, k, val = _dense(v, hmod, self.qkv).reshape(b, t, 3, num_heads, hd).unbind(2)
        if seq_group is not None:
            from rectified_flow_vision_tpu_torch.parallel.ring_attention import ring_attention

            att = ring_attention(q, k, val, seq_group)
        else:
            att = fused.flash_attention(q, k, val)
        tokens = _gated_row_dense(v, tokens, att.reshape(b, t, num_heads * hd), self.proj,
                                  gate_msa)
        # MLP branch
        hmod = v.to_tp(fused.ln_modulate(tokens, shift_mlp, scale_mlp))
        hmod = _dense(v, hmod, self.mlp1, act="gelu_tanh")
        return _gated_row_dense(v, tokens, hmod, self.mlp2, gate_mlp)


class _TimeEmbed(nn.Module):
    def __init__(self, hidden: int) -> None:
        super().__init__()
        self.lin1 = nn.Linear(TIME_BASIS, hidden)
        self.lin2 = nn.Linear(hidden, hidden)


class _FinalLayer(nn.Module):
    def __init__(self, hidden: int, out_dim: int) -> None:
        super().__init__()
        self.ada = nn.Linear(hidden, 2 * hidden)
        self.linear = nn.Linear(hidden, out_dim)


class DiT(nn.Module):
    """DiT velocity field: ``dit(x, t, dtype=...)`` with x NHWC latents, t [B]."""

    def __init__(
        self,
        input_size: int = 32,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        mlp_ratio: float = 4.0,
        size: Optional[str] = None,
        remat: bool = False,
    ) -> None:
        super().__init__()
        if size is not None:
            hidden_size, depth, num_heads = DIT_SIZES[size.upper()]
        self.cfg = cfg = DiTConfig(
            input_size=input_size,
            patch_size=patch_size,
            in_channels=in_channels,
            hidden_size=hidden_size,
            depth=depth,
            num_heads=num_heads,
            mlp_ratio=mlp_ratio,
            remat=remat,
        )
        h = cfg.hidden_size
        self.patch_embed = nn.Conv2d(cfg.in_channels, h, cfg.patch_size, stride=cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches, h))
        self.t_embed = _TimeEmbed(h)
        self.blocks = nn.ModuleList(
            DiTBlock(h, int(h * cfg.mlp_ratio)) for _ in range(cfg.depth)
        )
        self.final = _FinalLayer(h, cfg.patch_size * cfg.patch_size * cfg.out_channels)
        self._params = _ParamCache()
        self.tp = None  # a parallel.mesh.TensorParallel once shard_params splits the weights
        self.fsdp = False

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initialisation, drawn in module order from
        ``generator`` (on the CPU, so a seed gives the same weights on every
        device): torch-default uniform for the patch conv, N(0, 0.02) for the
        positions, xavier-uniform weights and zero biases for the dense
        layers, zeros for every adaLN projection and for the head."""

        def uniform_(p: Tensor, bound: float) -> None:
            u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
            p.copy_(u * (2 * bound) - bound)

        bound = 1.0 / math.sqrt(self.patch_embed.weight[0].numel())
        uniform_(self.patch_embed.weight, bound)
        uniform_(self.patch_embed.bias, bound)
        self.pos_embed.copy_(
            torch.randn(self.pos_embed.shape, generator=generator, dtype=torch.float32) * 0.02
        )
        zero = [self.final.ada, self.final.linear] + [blk.ada for blk in self.blocks]
        for m in self.modules():
            if not isinstance(m, nn.Linear):
                continue
            if any(m is z for z in zero):
                m.weight.zero_()
            else:
                out_dim, in_dim = m.weight.shape
                uniform_(m.weight, math.sqrt(6.0 / (in_dim + out_dim)))
            m.bias.zero_()

    def _time_embedding(self, t: Tensor, v: _View, dtype: torch.dtype) -> Tensor:
        # t in [0, 1] is used directly (the flow-matching convention)
        emb = P.sinusoidal_time_embedding(t, TIME_BASIS).to(dtype)
        emb = P.silu(v.dense(emb, self.t_embed.lin1))
        return v.dense(emb, self.t_embed.lin2)

    def forward(
        self,
        x: Tensor,
        t: Tensor,
        *,
        dtype: torch.dtype = torch.float32,
        masters: bool = False,
        mesh=None,
        seq_axis: Optional[str] = None,
    ) -> Tensor:
        """Velocity v(x, t) in ``dtype``. x: [B, H, W, C] NHWC latents; t: [B].
        ``masters`` keeps the fp32 parameters in the autograd graph (the
        loss); otherwise they are rounded through ``dtype`` first, ``pos_embed``
        included, as the JAX sampler casts its param tree. With ``mesh`` and
        ``seq_axis`` the tokens are split over that mesh dim (sequence
        parallelism, see the module docstring); the output is whole."""
        cfg = self.cfg
        group = mesh.get_group(seq_axis) if mesh is not None and seq_axis is not None else None
        v = _View(self._params, dtype, masters, self.tp, sum_grads=group if masters else None)
        tokens, c_emb = self._embed(x, t, v, dtype)
        if group is not None:
            n, r = collectives.group_size(group), collectives.group_rank(group)
            if tokens.shape[1] % n:
                raise ValueError(f"{tokens.shape[1]} tokens do not split over {n} ranks")
            rows = tokens.shape[1] // n
            tokens = tokens.narrow(1, r * rows, rows)

        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                tokens = checkpoint(
                    blk, tokens, c_emb, v, cfg.num_heads, group, use_reentrant=False,
                    preserve_rng_state=False,
                )
            else:
                tokens = blk(tokens, c_emb, v, cfg.num_heads, group)

        out = self._head(tokens, c_emb, v)
        if group is not None:
            out = collectives.all_gather(out, group, dim=1)
        return self._unpatchify(out, x.shape)

    def _embed(self, x: Tensor, t: Tensor, v: _View, dtype: torch.dtype):
        """Patch tokens + positions [B, T, hidden], and the time embedding."""
        b, hh, ww, _ = x.shape
        p = self.cfg.patch_size
        tokens = v.conv(x.to(dtype), self.patch_embed)  # [B, gh, gw, hidden]
        tokens = tokens.reshape(b, (hh // p) * (ww // p), self.cfg.hidden_size)
        return tokens + v(self.pos_embed), self._time_embedding(t, v, dtype)

    def _head(self, tokens: Tensor, c_emb: Tensor, v: _View) -> Tensor:
        """Final adaLN and the linear head: [B, T, p * p * C]."""
        shift, scale = v.dense(P.silu(c_emb), self.final.ada).chunk(2, dim=-1)
        tokens = fused.ln_modulate(tokens, shift, scale)
        return v.dense(tokens, self.final.linear)

    def _unpatchify(self, out: Tensor, shape) -> Tensor:
        b, hh, ww, _ = shape
        p, c = self.cfg.patch_size, self.cfg.out_channels
        out = out.reshape(b, hh // p, ww // p, p, p, c)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, c)

    def pipeline_apply(
        self,
        x: Tensor,
        t: Tensor,
        mesh,
        *,
        stage_axis: str = "stage",
        num_microbatches: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        masters: bool = False,
        stacked_blocks=None,
    ) -> Tensor:
        """GPipe forward: the block stack split over ``mesh``'s ``stage_axis``
        (``parallel/pipeline.py``); the patch embedding and the head run on
        every stage. ``stacked_blocks``: this stage's stacked block weights
        (``pipeline.split_pipeline_params``), else stacked from the module's
        own. Returns the whole output on every stage."""
        from rectified_flow_vision_tpu_torch.parallel import pipeline as PP

        cfg = self.cfg
        v = _View(self._params, dtype, masters)
        if stacked_blocks is None:
            stacked_blocks = PP.shard_stage_params(
                mesh, PP.stack_block_params(self.blocks, mesh.size(
                    mesh.mesh_dim_names.index(stage_axis))), stage_axis)
        if not masters:
            stacked_blocks = {k: val.detach() for k, val in stacked_blocks.items()}
        tokens, c_emb = self._embed(x, t, v, dtype)

        template = self.blocks[0]

        def block_fn(params, tok, c):
            return torch.func.functional_call(
                template, params, (tok, c, _View(None, dtype, True), cfg.num_heads))

        tokens = PP.pipeline_apply(
            block_fn, stacked_blocks, tokens, c_emb, mesh, stage_axis=stage_axis,
            num_microbatches=num_microbatches,
        )
        return self._unpatchify(self._head(tokens, c_emb, v), x.shape)

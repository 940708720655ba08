"""Pipeline parallelism: GPipe microbatches over a ``stage`` mesh dim.

Counterpart of the JAX package's ``parallel/pipeline.py``, with its SPMD
schedule. DiT's L blocks are split into S equal stages, one a rank of the
``stage`` dim. At tick t stage s runs microbatch t - s; after each tick the
activations and their time embeddings move to the next stage
(``collectives.ppermute``); the schedule runs M + S - 1 ticks, and one
``psum`` hands the last stage's outputs to every stage. Every stage holds
the patch embedding and the head, which run on every stage.

Training needs no hand-written backward schedule: ``ppermute``'s backward
sends each cotangent back one stage and ``psum``'s is the identity, so
autograd through the forward is GPipe's backward. The inputs that every
stage holds enter the pipeline through ``copy_to_group``, whose backward
sums the stages' cotangents, as the transpose of a replicated input of the
JAX package's ``shard_map`` does.

Parameters: ``stack_block_params`` stacks the blocks' weights by name to
[S, L / S, ...]; ``shard_stage_params`` keeps this rank's stage, [1, L / S,
...]; ``split_pipeline_params`` / ``merge_pipeline_params`` go between a
``DiT`` and that layout.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from rectified_flow_vision_tpu_torch.parallel import collectives as C

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def _stages(mesh, stage_axis: str) -> Tuple[object, int, int]:
    group = mesh.get_group(stage_axis)
    return group, C.group_size(group), C.group_rank(group)


def stack_block_params(blocks: Sequence[nn.Module], num_stages: int) -> Params:
    """Blocks -> each weight, by the block's own names, stacked to [S, L / S,
    ...]. The blocks must be alike, as DiT's are."""
    n = len(blocks)
    if n % num_stages != 0:
        raise ValueError(f"{n} blocks not divisible into {num_stages} stages")
    per = n // num_stages
    dicts = [dict(b.named_parameters()) for b in blocks]
    return {
        name: torch.stack([d[name].detach() for d in dicts]).reshape(
            (num_stages, per) + tuple(dicts[0][name].shape))
        for name in dicts[0]
    }


def shard_stage_params(mesh, stacked: Params, stage_axis: str = "stage") -> Params:
    """This rank's stage of stacked weights, [1, L / S, ...], as leaves that
    take gradients."""
    _, _, s = _stages(mesh, stage_axis)
    return {k: v[s : s + 1].clone().requires_grad_() for k, v in stacked.items()}


def pipeline_apply(
    block_fn: Callable[[Params, Tensor, Tensor], Tensor],
    stacked_params: Params,
    tokens: Tensor,
    c_emb: Tensor,
    mesh,
    *,
    stage_axis: str = "stage",
    num_microbatches: Optional[int] = None,
) -> Tensor:
    """Run token activations through the pipelined block stack.

    ``block_fn(one_block_params, tokens_mb, c_emb_mb) -> tokens_mb``;
    ``stacked_params``: this stage's [1, L / S, ...] weights; tokens [B, T, H]
    and c_emb [B, H], the same on every stage. B must split into the
    microbatches (S by default). Returns [B, T, H] on every stage.
    """
    group, num_stages, stage = _stages(mesh, stage_axis)
    m = num_microbatches or num_stages
    b = tokens.shape[0]
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    per = next(iter(stacked_params.values())).shape[1]
    blocks = [{k: v[0, j] for k, v in stacked_params.items()} for j in range(per)]
    tok_shape, c_shape = (b // m,) + tuple(tokens.shape[1:]), (b // m,) + tuple(c_emb.shape[1:])
    width = tokens[0].numel()

    # tokens and time embedding travel packed as one [rows, T*H + H] tensor,
    # so each hop is one collective in the forward and one in the backward
    def pack(x: Tensor, c: Tensor) -> Tensor:
        return torch.cat([x.reshape(x.shape[0], -1), c.reshape(c.shape[0], -1)], dim=1)

    def unpack(z: Tensor) -> Tuple[Tensor, Tensor]:
        return z[:, :width].reshape(tok_shape), z[:, width:].reshape(c_shape)

    inputs = C.copy_to_group(pack(tokens, c_emb), group).reshape(m, b // m, -1)
    first = torch.tensor(stage == 0, device=tokens.device)
    last = torch.tensor(stage == num_stages - 1, device=tokens.device)
    # Every stage computes every tick, and the stage's own role is chosen by
    # torch.where, as in the JAX schedule: each hop's output then lies on
    # the gradient path on every stage, so every stage runs every hop's
    # backward, in the same order.
    z = torch.zeros_like(inputs[0])
    out = [torch.zeros(tok_shape, dtype=tokens.dtype, device=tokens.device) for _ in range(m)]
    for t in range(m + num_stages - 1):
        if t < m:  # stage 0 takes microbatch t in
            z = torch.where(first, inputs[t], z)
        state, c_state = unpack(z)
        for blk in blocks:
            state = block_fn(blk, state, c_state)
        i = t - (num_stages - 1)
        if i >= 0:  # the last stage collects microbatch t - (S - 1)
            out[i] = torch.where(last, state, out[i])
        if t < m + num_stages - 2:  # hop to the next stage
            z = C.ppermute(pack(state, c_state), group)
    # only the last stage holds results; one psum gives them to every stage
    result = torch.where(last, torch.stack(out), torch.zeros_like(out[0]))
    return C.psum(result, group).reshape((b,) + tuple(tokens.shape[1:]))


def split_pipeline_params(dit, mesh, stage_axis: str = "stage") -> Tuple[Params, Params]:
    """A DiT -> (rest, stacked): ``rest`` its own parameters outside the
    block stack (patch embedding, positions, time MLP, head), the same on
    every stage; ``stacked`` this stage's blocks, [1, L / S, ...]."""
    _, num_stages, _ = _stages(mesh, stage_axis)
    rest = {k: p for k, p in dit.named_parameters() if not k.startswith("blocks.")}
    stacked = shard_stage_params(mesh, stack_block_params(dit.blocks, num_stages), stage_axis)
    return rest, stacked


def merge_pipeline_params(rest: Params, stacked: Params, mesh, stage_axis: str = "stage") -> Params:
    """Inverse of ``split_pipeline_params``: the whole DiT state dict, the
    stages' blocks gathered onto every rank (every stage must call it)."""
    group, num_stages, _ = _stages(mesh, stage_axis)
    full = {k: C.all_gather_nograd(v.detach(), group, dim=0) for k, v in stacked.items()}
    per = next(iter(full.values())).shape[1]
    merged = {k: v.detach() for k, v in rest.items()}
    for i in range(num_stages * per):
        s, j = divmod(i, per)
        merged.update({f"blocks.{i}.{k}": v[s, j] for k, v in full.items()})
    return merged


def make_pipeline_train_step(
    dit,
    optimizer_factory: Callable[[Sequence[Tensor]], torch.optim.Optimizer],
    mesh,
    *,
    stage_axis: str = "stage",
    num_microbatches: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
):
    """A flow-matching train step through the staged block stack.

    Returns ``(train_step, loss_fn)``. ``loss_fn(rest, blocks, x1, x0, t)``
    is the mean squared velocity error of ``dit.pipeline_apply`` on the
    pipeline layout (``split_pipeline_params``: ``rest`` are the DiT's own
    parameters). ``train_step(rest, blocks, x1, generator) -> loss`` draws
    x0 ~ N(0, I) and t ~ U[0, 1] for the batch from ``generator``, takes the
    gradient and steps the optimizer that ``optimizer_factory`` builds over
    (rest, blocks) at the first call, in place.
    """

    def loss_fn(rest: Params, blocks: Params, x1: Tensor, x0: Tensor, t: Tensor) -> Tensor:
        tb = t.float()[:, None, None, None]
        x_t = (1.0 - tb) * x0 + tb * x1
        pred = dit.pipeline_apply(
            x_t, t, mesh, stage_axis=stage_axis, num_microbatches=num_microbatches,
            dtype=dtype, masters=True, stacked_blocks=blocks,
        )
        return torch.mean(torch.square(pred.float() - (x1 - x0).float()))

    state = {}

    def train_step(rest: Params, blocks: Params, x1: Tensor, generator: torch.Generator) -> Tensor:
        if "opt" not in state:
            state["opt"] = optimizer_factory([*rest.values(), *blocks.values()])
        opt = state["opt"]
        x1 = x1.float()
        x0 = torch.randn(x1.shape, generator=generator, dtype=torch.float32, device=x1.device)
        t = torch.rand((x1.shape[0],), generator=generator, dtype=torch.float32, device=x1.device)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(rest, blocks, x1, x0, t)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step, loss_fn

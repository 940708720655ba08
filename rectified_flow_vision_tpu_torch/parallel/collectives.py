"""Collectives that carry gradients: the torch form of ``lax.ppermute`` and
``psum`` and of the all-gather that GSPMD emits.

The JAX package writes its parallel programs once and lets autograd
transpose them: ``ppermute``'s transpose is ``ppermute`` with the inverse
permutation, and a ``psum`` whose result every device holds transposes to
the identity. That is why its GPipe schedule needs no hand-written backward
(``parallel/pipeline.py``). The port's ranks are processes, so each
collective here is a ``torch.autograd.Function`` with that transpose as its
backward, on plain ``torch.distributed`` calls.

Every rank of a group computes the same loss, as the one JAX program does,
so a value that every rank holds (the result of ``psum``, ``all_gather``) has
the same cotangent on every rank. The backwards below are written for that
convention: ``psum``'s is the identity, ``all_gather``'s the rank's own
slice, and ``copy_to_group`` (the identity forward of a replicated value that
feeds rank-local work) sums its cotangents. ``torch.distributed.nn.functional``
is not used: its ``all_reduce`` sums the cotangents in the backward, which
counts a loss held on every rank once per rank.

A group of one rank makes each of these the identity (no message is sent,
so NCCL is never asked to send a tensor to its own rank).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _shift(x: Tensor, group, shift: int) -> Tensor:
    """Rank r receives rank (r - shift)'s x."""
    n = group_size(group)
    if n == 1 or shift % n == 0:
        return x
    r = group_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dst, group),
        dist.P2POp(dist.irecv, out, src, group),
    ])
    for req in reqs:
        req.wait()
    return out


def _fresh(y: Tensor, x: Tensor) -> Tensor:
    """A Function's output must not be its input itself (a group of one)."""
    return x.view_as(x) if y is x else y


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _fresh(_shift(x, group, shift), x)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x: Tensor, group, shift: int = 1) -> Tensor:
    """Rotate ``x`` around the group's ring: rank r gets rank (r - shift)'s
    value, as ``lax.ppermute`` with the pairs (i, i + shift). The backward
    sends the cotangent the other way round."""
    return _PPermute.apply(x, group, shift)


def _sum(x: Tensor, group) -> Tensor:
    if group_size(group) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _fresh(_sum(x, group), x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def psum(x: Tensor, group) -> Tensor:
    """Sum over the group, held by every rank (``lax.psum``); the backward is
    the identity."""
    return _Psum.apply(x, group)


def copy_to_group(x: Tensor, group) -> Tensor:
    """The identity on a value every rank holds, before rank-local work on
    it; the backward sums the ranks' cotangents (the transpose of ``psum``'s
    identity backward)."""
    return _CopyToGroup.apply(x, group)


def _gather(x: Tensor, group, dim: int) -> Tensor:
    n = group_size(group)
    if n == 1:
        return x
    parts: List[Tensor] = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return _fresh(_gather(x, group, dim), x)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), None, None


def all_gather(x: Tensor, group, dim: int = 0) -> Tensor:
    """Concatenate the ranks' ``x`` along ``dim``, in rank order, on every
    rank; the backward takes the rank's own slice of the cotangent."""
    return _AllGather.apply(x, group, dim)


def all_gather_nograd(x: Tensor, group, dim: int = 0) -> Tensor:
    """``all_gather`` outside autograd (sampling)."""
    return _gather(x, group, dim)

"""Ring attention: exact attention over a sequence split across ranks.

Counterpart of the JAX package's ``parallel/ring_attention.py``. Each rank
holds one block of the tokens' q, k and v; the k / v blocks go round the
ring (``collectives.ppermute``) while each rank merges its queries' partial
results by the online softmax (running maximum, running sum), the flash
attention recurrence lifted to the ranks. The backward is autograd's,
through ``ppermute``'s inverse rotation. The product of one q block with
one k / v block is a plain matmul with fp32 logits, as the JAX package's
``_block_attn`` is a plain einsum.

``ring_attention`` is the rank-local form (inside a sequence-parallel
forward); ``ring_attention_sharded`` takes the whole [B, T, H, D] on every
rank, runs the ring on each rank's tokens and returns the whole output.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from rectified_flow_vision_tpu_torch.parallel import collectives as C

Tensor = torch.Tensor


def _block_attn(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """One q block against one k / v block, fp32 partials: row max m and row
    sum l [B, H, Tq], output o [B, Tq, H, D]."""
    s = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float().transpose(1, 2))  # [B, H, Tq, D]
    return m, l, o.transpose(1, 2)


def ring_attention(q: Tensor, k: Tensor, v: Tensor, group) -> Tensor:
    """Exact attention with k / v rotating around the group's ring. q, k, v:
    this rank's [B, T_local, H, D] token block; returns its output block in
    q's dtype."""
    n = C.group_size(group)
    scale = 1.0 / math.sqrt(q.shape[-1])
    m, l, o = _block_attn(q, k, v, scale)
    kv = torch.cat([k, v], dim=-1)  # one hop a step, forward and backward
    d = k.shape[-1]
    for _ in range(n - 1):
        kv = C.ppermute(kv, group)
        m_b, l_b, o_b = _block_attn(q, kv[..., :d], kv[..., d:], scale)
        m_new = torch.maximum(m, m_b)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_b - m_new)
        l = l * alpha + l_b * beta
        o = o * alpha.transpose(1, 2)[..., None] + o_b * beta.transpose(1, 2)[..., None]
        m = m_new
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention_sharded(q: Tensor, k: Tensor, v: Tensor, mesh, seq_axis: str = "seq") -> Tensor:
    """The whole [B, T, H, D] in and out on every rank of ``mesh``'s
    ``seq_axis``: each rank runs the ring on its T / n tokens, and the
    blocks are gathered (with their gradient)."""
    group = mesh.get_group(seq_axis)
    n, r = C.group_size(group), C.group_rank(group)
    t = q.shape[1]
    if t % n:
        raise ValueError(f"{t} tokens do not split over {n} ranks of {seq_axis!r}")
    rows = t // n

    def mine(x: Tensor) -> Tensor:
        return C.copy_to_group(x, group).narrow(1, r * rows, rows)

    out = ring_attention(mine(q), mine(k), mine(v), group)
    return C.all_gather(out, group, dim=1)


def reference_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Unsharded ground truth: [B, T, H, D]."""
    s = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1))
    p = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float().transpose(1, 2)).transpose(1, 2).to(q.dtype)

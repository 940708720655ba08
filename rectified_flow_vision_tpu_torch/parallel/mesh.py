"""Process groups, the ``('data', 'model')`` mesh and parameter placement.

Counterpart of the JAX package's ``parallel/mesh.py``. The JAX package is one
program over every device, and GSPMD emits its collectives from sharding
annotations. The port is SPMD over processes, one a card as ``torchrun``
starts them, on a ``torch.distributed.device_mesh.DeviceMesh`` with the same
dims, and keeps each public function's meaning for the global batch:

* data parallel over ``data``: each rank takes its rows of the global batch
  (``shard_batch``), and the gradients are averaged over the data group;
* tensor parallel over ``model`` by ``_TP_RULES`` (the Megatron pattern):
  each rank keeps explicit local shards of the matching parameters as plain
  tensors, so the hand-written kernels run on the rank's channels, and the
  model's forward adds the collectives (``models/unet.py``);
* FSDP over ``data``: ``torch.distributed.fsdp.fully_shard`` (FSDP2) on each
  residual block, the attention block and the network, composed with the
  tensor-parallel shards, each parameter split on the dim ``fsdp_spec``
  picks.

``full_state_dict`` gathers the whole parameters back from either layout,
and ``unshard`` puts them back into a plain network, so a checkpoint is the
``.npz`` the JAX package reads.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from rectified_flow_vision_tpu_torch.parallel import collectives as C

DATA_AXIS = "data"
MODEL_AXIS = "model"

Tensor = torch.Tensor
Spec = Tuple[Optional[str], ...]


def maybe_init_distributed() -> bool:
    """Join the process group when launched under ``torchrun`` (its ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``): NCCL on the card, each process on card
    ``LOCAL_RANK``, gloo without one. False when not launched so; True when a
    group exists. Call it first thing in an entry point."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend=backend, init_method="env://")
    return True


def create_mesh(
    data_axis: int = -1,
    model_axis: int = 1,
    device: str | torch.device = "cuda",
):
    """A 2-D ``DeviceMesh`` with dims ``('data', 'model')`` over the ranks of
    the process group; ``data_axis == -1`` takes every rank that
    ``model_axis`` leaves. Ranks are laid out row-major, so one model group
    is consecutive ranks (the cards of one host under ``torchrun``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs a process group: launch under torchrun (and call "
            "maybe_init_distributed) or call torch.distributed.init_process_group"
        )
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"model_axis={model_axis} must divide device count {n}")
    dp = n // model_axis if data_axis == -1 else data_axis
    if dp * model_axis != n:
        raise ValueError(f"mesh {dp}x{model_axis} does not cover {n} devices")
    ranks = torch.arange(n).reshape(dp, model_axis)
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    """The size of a mesh dim; 1 for no mesh or a dim the mesh lacks."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def mesh_devices(mesh) -> int:
    """How many ranks the mesh spans."""
    return 1 if mesh is None else int(mesh.mesh.numel())


def effective_mesh(mesh):
    """None for a one-device mesh: the trainers take it for no mesh (the same
    math, random draws and permutations without the collectives' cost), as
    the JAX trainers do. ``make_train_step`` / ``make_train_epoch`` still
    honour an explicit one-device mesh."""
    return None if mesh_devices(mesh) == 1 else mesh


def replicated(mesh, t: Tensor) -> Tensor:
    """Make ``t`` the same on every rank of the mesh: the mesh's first rank's
    value, broadcast in place."""
    if mesh_devices(mesh) > 1:
        dist.broadcast(t, src=int(mesh.mesh.flatten()[0]))
    return t


def shard_batch(mesh, batch: Tensor) -> Tensor:
    """This rank's rows of a global batch, split over ``data`` (the batch
    itself without a mesh)."""
    if mesh is None:
        return batch
    dp = axis_size(mesh, DATA_AXIS)
    if batch.shape[0] % dp:
        raise ValueError(f"batch {batch.shape[0]} does not split over {dp} data ranks")
    rows = batch.shape[0] // dp
    return batch.narrow(0, axis_rank(mesh, DATA_AXIS) * rows, rows)


def gather_batch(mesh, rows: Tensor) -> Tensor:
    """The global batch from each data rank's rows, on every rank (no
    gradient)."""
    if axis_size(mesh, DATA_AXIS) == 1:
        return rows
    return C.all_gather_nograd(rows, axis_group(mesh, DATA_AXIS), dim=0)


def data_mean(mesh, x: Tensor) -> Tensor:
    """The mean of ``x`` over the data group (a per-rank loss -> the global
    batch's)."""
    x = x.clone()
    dist.all_reduce(x, group=axis_group(mesh, DATA_AXIS))
    return x / axis_size(mesh, DATA_AXIS)


def average_grads(mesh, params: Sequence[Tensor]) -> None:
    """Average the parameters' gradients over ``data``, in place, in one
    collective over a flat buffer (data parallelism without FSDP)."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=axis_group(mesh, DATA_AXIS))
    flat /= axis_size(mesh, DATA_AXIS)
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(parts, grads)])


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: Tensor) -> Tensor:
    """This rank's part of a tensor: an FSDP shard's local tensor, else the
    tensor."""
    return t.to_local() if is_dtensor(t) else t


def like(t: Tensor, ref: Tensor) -> Tensor:
    """``t`` (a local tensor) as a shard placed like ``ref``, if ``ref`` is one."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, ref.placements, shape=ref.shape,
                              stride=ref.stride())


def local_tree(obj):
    """``obj`` (nested dicts, lists, tensors) with every FSDP shard replaced by
    its local tensor, for ``torch.save``."""
    if isinstance(obj, dict):
        return {k: local_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(local_tree(v) for v in obj)
    return local(obj) if isinstance(obj, Tensor) else obj


def barrier() -> None:
    """Wait for every rank of a process group of more than one."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def writes_files() -> bool:
    """Whether this process writes shared files: rank 0 of a process group,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# Tensor-parallel rules, by state-dict name (torch layouts: conv OIHW, Linear
# (out, in)). A spec names the mesh dim of each tensor dim, as a JAX
# PartitionSpec does.
# ---------------------------------------------------------------------------

_P = r"(?:.*\.)?"
_RES = _P + r"(?:(?:enc|dec)_blocks\.\d+|mid_block\d)\."
_TP_RULES = [
    # --- UNet -------------------------------------------------------------
    # attention: heads over the out dim of qkv (q, k and v each split by
    # heads, ``_split``), the in dim of proj
    (re.compile(_P + r"mid_attn\.qkv\.weight"), (MODEL_AXIS, None, None, None)),
    (re.compile(_P + r"mid_attn\.qkv\.bias"), (MODEL_AXIS,)),
    (re.compile(_P + r"mid_attn\.proj\.weight"), (None, MODEL_AXIS, None, None)),
    # res-block convs, Megatron pattern: conv1 column-parallel (out
    # channels), with norm2's affine and the time projection that act on
    # them; conv2 row-parallel (in channels), summed over the group. The 8
    # GroupNorm groups are contiguous channel blocks, so model_axis in
    # {2, 4, 8} keeps each group on one rank.
    (re.compile(_RES + r"conv1\.weight"), (MODEL_AXIS, None, None, None)),
    (re.compile(_RES + r"conv1\.bias"), (MODEL_AXIS,)),
    (re.compile(_RES + r"norm2\.(?:weight|bias)"), (MODEL_AXIS,)),
    (re.compile(_RES + r"conv2\.weight"), (None, MODEL_AXIS, None, None)),
    # time MLP: its 4C hidden dim (lin1 = time_mlp.1 column, lin2 =
    # time_mlp.3 row); each res-block's time projection (time_mlp.1) is
    # column-parallel with conv1's out channels
    (re.compile(_P + r"time_mlp\.1\.weight"), (MODEL_AXIS, None)),
    (re.compile(_P + r"time_mlp\.1\.bias"), (MODEL_AXIS,)),
    (re.compile(_P + r"time_mlp\.3\.weight"), (None, MODEL_AXIS)),
    # --- DiT (column-parallel in, row-parallel out) ------------------------
    (re.compile(_P + r"blocks\.\d+\.qkv\.weight"), (MODEL_AXIS, None)),
    (re.compile(_P + r"blocks\.\d+\.qkv\.bias"), (MODEL_AXIS,)),
    (re.compile(_P + r"blocks\.\d+\.proj\.weight"), (None, MODEL_AXIS)),
    (re.compile(_P + r"blocks\.\d+\.mlp1\.weight"), (MODEL_AXIS, None)),
    (re.compile(_P + r"blocks\.\d+\.mlp1\.bias"), (MODEL_AXIS,)),
    (re.compile(_P + r"blocks\.\d+\.mlp2\.weight"), (None, MODEL_AXIS)),
]


def unet_param_spec(name: str, ndim: int) -> Spec:
    """The tensor-parallel spec of one parameter, by its state-dict name; all
    ``None`` (replicated) where no rule matches: the downsample, upsample,
    shortcut and head convs, norm1 and the biases of row-parallel layers."""
    for pattern, spec in _TP_RULES:
        if pattern.fullmatch(name):
            return spec
    return (None,) * ndim


def _model_dim(name: str, ndim: int) -> Optional[int]:
    spec = unet_param_spec(name, ndim)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _grouped(name: str) -> bool:
    """qkv's out dim is [q | k | v], each split by heads."""
    return name.endswith("qkv.weight") or name.endswith("qkv.bias")


def _split(name: str, t: Tensor, dim: int, n: int, r: int) -> Tensor:
    """Rank r's part of the whole ``t`` along ``dim``."""
    if _grouped(name):
        parts = t.reshape((3, t.shape[0] // 3) + tuple(t.shape[1:]))
        return parts.chunk(n, dim=1)[r].reshape((-1,) + tuple(t.shape[1:]))
    return t.chunk(n, dim=dim)[r]


def _join(name: str, parts: Sequence[Tensor], dim: int) -> Tensor:
    """The whole tensor from every rank's part, in rank order."""
    if _grouped(name):
        rest = tuple(parts[0].shape[1:])
        grouped = [p.reshape((3, p.shape[0] // 3) + rest) for p in parts]
        return torch.cat(grouped, dim=1).reshape((-1,) + rest)
    return torch.cat(list(parts), dim=dim)


def fsdp_spec(shape, dp: int, base: Optional[Spec] = None) -> Spec:
    """``base`` (a tensor-parallel spec) with ``data`` added on the largest
    free dim divisible by ``dp``; unchanged (replicated over ``data``) when
    no dim qualifies."""
    parts = list(base) if base is not None else []
    parts += [None] * (len(shape) - len(parts))
    best = None
    for i, d in enumerate(shape):
        if parts[i] is not None or d % dp != 0 or d < dp:
            continue
        if best is None or shape[i] > shape[best]:
            best = i
    if best is not None:
        parts[best] = DATA_AXIS
    return tuple(parts)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorParallel:
    """A network's tensor-parallel group: its forward runs the rank's shards
    and adds the collectives."""

    group: object
    size: int
    rank: int


def _network(model) -> nn.Module:
    return getattr(model, "velocity_net", model)


def shard_params(mesh, model):
    """Tensor parallel over ``model``: keep this rank's shard of every
    parameter that ``_TP_RULES`` splits, in place, and give the network (a
    UNet or a DiT) its group. Returns ``model``. A no-op on a mesh whose
    model dim is 1."""
    tp = axis_size(mesh, MODEL_AXIS)
    net = _network(model)
    if tp == 1:
        return model
    if getattr(net, "tp", None) is not None:
        raise ValueError("the network is already tensor-parallel")
    if hasattr(net, "cfg"):  # a DiT: its heads and MLP columns split
        if net.cfg.num_heads % tp or int(net.cfg.hidden_size * net.cfg.mlp_ratio) % tp:
            raise ValueError(f"model_axis={tp} must divide the DiT's {net.cfg.num_heads} heads "
                             "and its MLP width")
    elif net.norm_groups % tp or net.mid_attn.num_heads % tp:
        raise ValueError(
            f"model_axis={tp} must divide the {net.norm_groups} GroupNorm groups and the "
            f"{net.mid_attn.num_heads} attention heads"
        )
    r = axis_rank(mesh, MODEL_AXIS)
    with torch.no_grad():
        for name, p in net.named_parameters():
            dim = _model_dim(name, p.ndim)
            if dim is not None:
                p.data = _split(name, p.data, dim, tp, r).contiguous().clone()
    net.tp = TensorParallel(axis_group(mesh, MODEL_AXIS), tp, r)
    return model


def shard_params_fsdp(mesh, model, *, tp: bool = True):
    """FSDP over ``data`` (``fully_shard`` on each residual and attention
    block, then on the network), after the tensor-parallel shards when
    ``tp``. Each parameter is split on the dim ``fsdp_spec`` picks (dim 0,
    padded, where none divides). Returns ``model``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    if tp:
        shard_params(mesh, model)
    net = _network(model)
    dp = axis_size(mesh, DATA_AXIS)
    names = {id(p): n for n, p in net.named_parameters()}

    def placement(p):
        spec = fsdp_spec(tuple(p.shape), dp, unet_param_spec(names[id(p)], p.ndim))
        return Shard(spec.index(DATA_AXIS)) if DATA_AXIS in spec else None

    sub = mesh[DATA_AXIS]
    for m in list(net.modules()):
        if m is not net and type(m).__name__ in ("ResidualBlock", "AttentionBlock", "DiTBlock"):
            fully_shard(m, mesh=sub, shard_placement_fn=placement)
    fully_shard(net, mesh=sub, shard_placement_fn=placement)
    net.fsdp = True
    return model


def place_params(mesh, model, *, fsdp: bool = False):
    """Place a model's parameters: FSDP (+ tensor parallel) or tensor
    parallel / replicated. The model's parameters are first made equal on
    every rank (rank 0's)."""
    if mesh is None:
        return model
    net = _network(model)
    with torch.no_grad():
        for p in net.parameters():
            replicated(mesh, p.data)
    if fsdp:
        shard_params_fsdp(mesh, model)
    else:
        shard_params(mesh, model)
    net.mesh = mesh
    return model


def is_parallel(model) -> bool:
    """Whether the model's network is placed on a mesh (``place_params``,
    ``shard_params``): then every rank holds a part or a copy of it, every
    rank must take part in reading it whole, and rank 0 writes it."""
    net = _network(model)
    return (getattr(net, "mesh", None) is not None or getattr(net, "tp", None) is not None
            or getattr(net, "fsdp", False))


def full_tensors(model, named: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Whole tensors from ``named`` (the network's parameters by state-dict
    name, or an EMA of them) in the model's layout: FSDP shards gathered over
    ``data``, tensor-parallel shards over ``model``. Every rank must call it;
    each gets the whole tensors."""
    net = _network(model)
    tp: Optional[TensorParallel] = getattr(net, "tp", None)
    out = {}
    for name, t in named.items():
        t = t.detach()
        if is_dtensor(t):
            t = _gather_fsdp_shard(t)
        dim = _model_dim(name, t.ndim) if tp is not None else None
        if dim is not None:
            parts = [torch.empty_like(t) for _ in range(tp.size)]
            dist.all_gather(parts, t.contiguous(), group=tp.group)
            t = _join(name, parts, dim)
        out[name] = t
    return out


def _gather_fsdp_shard(t) -> Tensor:
    """The whole tensor of an FSDP shard (a ``DTensor`` split on one dim over
    ``data``), by a plain ``all_gather`` of the shards padded to one size
    (the torch.chunk split FSDP2 uses)."""
    (placement,) = t.placements
    local = t.to_local()
    if not placement.is_shard():
        return local
    dim, group = placement.dim, t.device_mesh.get_group()
    n, size = dist.get_world_size(group), t.shape[dim]
    chunk = -(-size // n)
    if local.shape[dim] < chunk:
        pad = list(local.shape)
        pad[dim] = chunk - local.shape[dim]
        local = torch.cat([local, local.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, size)


def full_state_dict(model) -> Dict[str, Tensor]:
    """``model.state_dict()`` with whole tensors (see ``full_tensors``)."""
    return full_tensors(model, dict(model.named_parameters()))


def unshard(model):
    """Put whole parameters back into a plain network (a new module of the
    same class and config, on the same device); the inverse of
    ``place_params``. Every rank must call it. Returns ``model``."""
    if not is_parallel(model):
        return model
    net = _network(model)
    if getattr(net, "tp", None) is None and not getattr(net, "fsdp", False):
        net.mesh = None  # data parallel: every rank holds the whole weights
        return model
    full = full_tensors(model, dict(net.named_parameters()))
    fresh = model.new_network()
    fresh.load_state_dict(full, strict=True)
    model.velocity_net = fresh.to(next(iter(full.values())).device)
    model._sampler_cache.clear()  # its samplers hold the old network
    return model

"""Flow-matching base model: the velocity field (UNet, DiT or FLUX), flow
math, samplers and training.

Counterpart of the JAX package's ``models/base_flow.py``:

* path: x_t = (1-t) x0 + t x1, target velocity x1 - x0;
* loss: mean squared error of the predicted velocity, with t drawn uniform,
  logit-normal or u-shaped, on fresh noise or on coupled (x0, x1) pairs;
* training: AdamW + per-epoch cosine schedule + global-norm clip at 1.0,
  optional EMA of the weights, one epoch as a loop over a corpus resident on
  the device with the step losses read once at its end. Parameters, optimizer
  state and EMA are updated in place, where the JAX step returns new trees;
* samplers: Euler (left-endpoint times t_i = i/N), midpoint and Heun, and
  the reverse ODE (``invert``). Model compute runs in ``sample_dtype``
  (bf16 by default) while the integration state stays fp32, as in the JAX
  sampler; a Python loop takes the place of ``lax.scan``. A conditional
  backbone (FLUX, ``cond_shapes``) takes its prompts' rows as ``cond``, a
  dict of tensors by name with one row per image, passed to every step;
  unconditional backbones take none;
* spans (``utils.profiling.annotate``, free while no profiler records):
  ``rfv.sampler.step`` around each ODE step; ``rfv.train.gather`` around a
  step's batch gather; ``rfv.train.step`` around a step, holding
  ``rfv.train.loss``, ``.backward``, ``.optimizer`` and ``.ema``;
* checkpoints: the same ``.npz`` (param tree + ``__config__``) as the JAX
  package, and reference ``.pt`` files.

``BaseFlowModel`` is an ``nn.Module`` whose only child is ``velocity_net``,
so its ``state_dict`` has the reference checkpoint's ``velocity_net.`` keys.
It lives on ``device`` ("cuda" by default; "cpu" only when asked for). The
public tensor API takes and returns NCHW by default, like the JAX package;
pass ``data_format="NHWC"`` to stay in the internal layout.

Randomness is explicit: the loss draws noise, times and dropout seeds from a
``torch.Generator`` on the model's device (or takes them as arguments), and
the trainers seed one generator per epoch, so a seed fixes the trajectory
and a run resumed from its saved train state (``resume_dir``,
``utils/train_state.py``) repeats the uninterrupted one.

Meshes (``parallel/mesh.py``): the trainers and step functions take ``mesh``
(a ``('data', 'model')`` ``DeviceMesh``) and ``fsdp``. Each rank holds the
corpus and the same permutation and trains on its rows of every global
batch; the noise and times of the whole batch are drawn on every rank from
the same generator and each rank keeps its rows, and each rank's dropout
seeds are folded by its data rank, as the JAX package's sharded kernel
folds them. Gradients are averaged over ``data`` (FSDP2's reduce-scatter
under ``fsdp``), the clip takes the norm of the whole gradient, and
checkpoints hold the whole parameters, written by rank 0.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from rectified_flow_vision_tpu_torch.models.dit import DiT
from rectified_flow_vision_tpu_torch.models.flux import Flux
from rectified_flow_vision_tpu_torch.models.unet import UNet, count_parameters
from rectified_flow_vision_tpu_torch.parallel import mesh as mesh_lib
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt_io
from rectified_flow_vision_tpu_torch.utils import pt_import
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger
from rectified_flow_vision_tpu_torch.utils.profiling import annotate

log = get_logger("flow_vision.models")

Tensor = torch.Tensor
Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return device


def _to_nhwc(x, data_format: str, device: torch.device) -> Tensor:
    x = torch.as_tensor(x if isinstance(x, Tensor) else np.array(x), device=device)
    if data_format.upper() == "NCHW":
        x = x.permute(0, 2, 3, 1)
    return x.contiguous()


def _from_nhwc(x: Tensor, data_format: str) -> Tensor:
    if data_format.upper() == "NCHW":
        return x.permute(0, 3, 1, 2)
    return x


class BaseFlowModel(nn.Module):
    """Flow-matching model: a UNet, DiT or FLUX velocity field + flow math +
    sampler. FLUX (``backbone="flux"``) samples only: its prompts' encoder
    outputs come as ``cond``; it has no training path and no param tree.
    ``weights`` (the velocity network's state dict) are taken as they are,
    assigned and not copied where they are on ``device``: no initial weights
    are drawn, and a model of billions of parameters is never held twice."""

    def __init__(
        self,
        image_size: int = 64,
        in_channels: int = 3,
        model_channels: int = 64,
        channel_mult: Sequence[int] = (1, 2, 4),
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (16, 8),
        dropout: float = 0.1,
        *,
        backbone: str = "unet",
        patch_size: int = 2,
        hidden_size: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        mlp_ratio: float = 4.0,
        dit_size: Optional[str] = None,
        remat: bool = False,
        depth_single_blocks: int = 38,
        context_in_dim: int = 4096,
        context_tokens: int = 256,
        vec_in_dim: int = 768,
        axes_dim: Sequence[int] = (16, 56, 56),
        theta: int = 10000,
        qkv_bias: bool = True,
        seed: int = 0,
        params: Optional[Params] = None,
        weights: Optional[Dict[str, Tensor]] = None,
        compute_dtype: str = "float32",
        sample_dtype: str = "bfloat16",
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        if backbone not in ("unet", "dit", "flux"):
            raise ValueError(f"unknown backbone {backbone!r} (unet|dit|flux)")
        self.remat = bool(remat)
        self.image_size = image_size
        self.in_channels = in_channels
        self.backbone = backbone
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.sample_dtype = _DTYPES[sample_dtype]
        if backbone == "dit":
            self._net_args = dict(
                input_size=image_size,
                patch_size=patch_size,
                in_channels=in_channels,
                hidden_size=hidden_size,
                depth=depth,
                num_heads=num_heads,
                mlp_ratio=mlp_ratio,
                size=dit_size,
                remat=remat,
            )
        elif backbone == "flux":
            self._net_args = dict(
                input_size=image_size, in_channels=in_channels, patch_size=patch_size,
                hidden_size=hidden_size, num_heads=num_heads, mlp_ratio=mlp_ratio, depth=depth,
                depth_single_blocks=depth_single_blocks, context_in_dim=context_in_dim,
                context_tokens=context_tokens, vec_in_dim=vec_in_dim, axes_dim=tuple(axes_dim),
                theta=theta, qkv_bias=qkv_bias,
            )
        else:
            self._net_args = dict(
                in_channels=in_channels,
                model_channels=model_channels,
                out_channels=in_channels,
                channel_mult=channel_mult,
                num_res_blocks=num_res_blocks,
                attention_resolutions=attention_resolutions,
                dropout=dropout,
            )
        if weights is not None:  # taken as they are: nothing drawn, no second copy
            with torch.device("meta"):
                self.velocity_net = self.new_network()
            self.velocity_net.load_state_dict(weights, strict=True, assign=True)
        elif backbone == "flux":  # billions of parameters: made and drawn on the device
            with torch.device("meta"):
                self.velocity_net = self.new_network()
            self.velocity_net.to_empty(device=self.device)
            self.velocity_net.reset_parameters(
                torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.velocity_net = self.new_network()
            self.velocity_net.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if params is not None:
            self.params = params
        self._sampler_cache: Dict[tuple, Callable] = {}

    # ---- config / identity ------------------------------------------------

    @property
    def config(self) -> dict:
        n = self.velocity_net
        base = {
            "model_type": type(self).__name__,
            "image_size": self.image_size,
            "in_channels": self.in_channels,
            "backbone": self.backbone,
        }
        if self.backbone == "dit":
            c = n.cfg
            base.update(
                patch_size=c.patch_size,
                hidden_size=c.hidden_size,
                depth=c.depth,
                num_heads=c.num_heads,
                mlp_ratio=c.mlp_ratio,
                remat=c.remat,
            )
        elif self.backbone == "flux":
            c = n.cfg
            base.update(
                patch_size=c.patch_size, hidden_size=c.hidden_size, num_heads=c.num_heads,
                mlp_ratio=c.mlp_ratio, depth=c.depth, depth_single_blocks=c.depth_single_blocks,
                context_in_dim=c.context_in_dim, context_tokens=c.context_tokens,
                vec_in_dim=c.vec_in_dim, axes_dim=list(c.axes_dim), theta=c.theta,
                qkv_bias=c.qkv_bias,
            )
        else:
            base.update(
                model_channels=n.model_channels,
                channel_mult=list(n.channel_mult),
                num_res_blocks=n.num_res_blocks,
                attention_resolutions=list(n.attention_resolutions),
                dropout=n.dropout,
            )
        return base

    def num_parameters(self) -> int:
        return count_parameters(self)

    def new_network(self) -> nn.Module:
        """A fresh velocity network of this model's architecture (on the
        default device, the CPU unless a caller sets one; initial weights not
        drawn)."""
        return {"dit": DiT, "flux": Flux}.get(self.backbone, UNet)(**self._net_args)

    @property
    def cond_shapes(self) -> Optional[Dict[str, Tuple[int, ...]]]:
        """One image's conditioning rows by name (a conditional backbone), or
        None: the network samples without conditioning."""
        return getattr(self.velocity_net, "cond_shapes", None)

    def _no_flux(self, what: str) -> None:
        if self.backbone == "flux":
            raise NotImplementedError(
                f"{what}: the flux backbone serves only; conditional training and Reflow of "
                "it are not ported (ROADMAP), and it has no JAX param tree")

    @property
    def params(self) -> Params:
        """The weights as the JAX package's param tree (numpy, HWIO / (in, out)).
        While the network is placed on a mesh, every rank must read it: the
        whole weights are gathered."""
        self._no_flux("params")
        sd = mesh_lib.full_state_dict(self) if mesh_lib.is_parallel(self) else self.state_dict()
        sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
        return pt_import.backbone_state_dict_to_params(sd, self.backbone)

    @params.setter
    def params(self, tree: Params) -> None:
        self._no_flux("params")
        n = self.velocity_net
        if self.backbone == "dit":
            sd = pt_import.tree_to_state_dict(tree, "velocity_net.")
        else:
            sd = pt_import.params_to_state_dict(tree, list(n.channel_mult), n.num_res_blocks)
        own = self.state_dict()
        bad = [
            f"{k}: model {tuple(own[k].shape)} vs checkpoint {np.shape(v)}"
            for k, v in sd.items()
            if k in own and tuple(own[k].shape) != tuple(np.shape(v))
        ]
        if bad:
            raise ValueError(
                "checkpoint shape mismatch: " + "; ".join(bad[:5])
                + (f" (+{len(bad) - 5} more)" if len(bad) > 5 else "")
            )
        self.load_state_dict(
            {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()},
            strict=True,
        )

    # ---- flow math ---------------------------------------------------------

    @staticmethod
    def get_interpolation(x0: Tensor, x1: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
        """Linear interpolation x_t and target velocity (x1 - x0); t [B]
        broadcasts over all trailing dims."""
        t = torch.as_tensor(t, device=x0.device).reshape((-1,) + (1,) * (x0.ndim - 1))
        t = t.to(x0.dtype)
        return (1.0 - t) * x0 + t * x1, x1 - x0

    def loss_fn(
        self,
        x1: Tensor,
        generator: Optional[torch.Generator] = None,
        *,
        x0: Optional[Tensor] = None,
        t: Optional[Tensor] = None,
        seeds: Optional[Tensor] = None,
        train: bool = True,
        time_sampling: str = "uniform",
        mesh=None,
    ) -> Tensor:
        """Flow-matching loss on an NHWC batch on the model's device, as a
        scalar in the autograd graph of the fp32 parameters.

        ``x0`` given is the coupled-pair (reflow) loss; ``x0`` None draws
        fresh noise. What is not given is drawn from ``generator`` (by default
        the model's seeded one) in the order x0, t, dropout seeds: ``t`` per
        ``time_sampling`` ("uniform"; "logit_normal", which concentrates on
        mid-path; "u_shaped", the arcsine law peaked at both ends), and with
        ``train`` one int32 dropout seed per residual block of a UNet. A DiT
        has no dropout and takes ``remat`` at construction.

        With ``mesh``, x1 (and x0) are this rank's rows of the global batch:
        the noise and times of the whole batch are drawn and this rank's rows
        kept, and the drawn dropout seeds are folded by the data rank. The
        loss is the mean over this rank's rows.
        """
        self._no_flux("loss_fn")
        gen = generator if generator is not None else self.generator
        net = self.velocity_net
        dp, rank = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS), 0
        rows = x1.shape[0]
        if dp > 1:
            rank = mesh_lib.axis_rank(mesh, mesh_lib.DATA_AXIS)
        if x0 is None:
            x0 = torch.randn((rows * dp,) + tuple(x1.shape[1:]), generator=gen, dtype=x1.dtype,
                             device=x1.device).narrow(0, rank * rows, rows)
        if t is None:
            t = sample_times(time_sampling, rows * dp, gen, x1.device).narrow(0, rank * rows, rows)
        unet = self.backbone == "unet"
        if unet and seeds is None and train and net.dropout > 0:
            seeds = torch.randint(
                2**31 - 1, (net.num_dropout_seeds,), generator=gen, dtype=torch.int32,
                device=x1.device,
            )
            if mesh is not None:
                seeds = seeds + rank
        x_t, target = self.get_interpolation(x0, x1, t)
        extra = dict(train=train, seeds=seeds, remat=self.remat) if unet else {}
        pred = net(x_t, t, dtype=self.compute_dtype, masters=True, **extra)
        return torch.mean(torch.square(pred.float() - target.float()))

    @torch.no_grad()
    def compute_loss(
        self, x1, generator: Optional[torch.Generator] = None, data_format: str = "NCHW"
    ) -> Tensor:
        """Convenience loss on a data batch, in eval mode."""
        x1 = _to_nhwc(x1, data_format, self.device).float()
        return self.loss_fn(x1, generator, train=False)

    # ---- inference ----------------------------------------------------------

    @torch.no_grad()
    def forward(self, x, t, data_format: str = "NCHW", cond: Optional[Dict[str, Tensor]] = None
                ) -> Tensor:
        """The velocity field v(x, t), computed in ``compute_dtype``; a
        conditional backbone takes ``cond``, one row per image."""
        x = _to_nhwc(x, data_format, self.device)
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device).reshape(-1)
        extra = {} if cond is None else {"cond": cond}
        return _from_nhwc(self.velocity_net(x, t, dtype=self.compute_dtype, **extra), data_format)

    def _get_sampler(
        self,
        num_steps: int,
        return_trajectory: bool,
        dtype: torch.dtype,
        method: str = "euler",
        reverse: bool = False,
    ) -> Callable[[Tensor], Any]:
        """``sampler(noise_nhwc, cond=None) -> x`` (or ``(x, [x_1..x_N])``),
        cached per (steps, trajectory, dtype, method, direction); ``cond``
        (a conditional backbone's rows, one per image) is cast to ``dtype``
        once and passed to every velocity."""
        if method not in ("euler", "midpoint", "heun"):
            raise ValueError(f"unknown method {method!r}")
        key = (num_steps, bool(return_trajectory), dtype, method, bool(reverse))
        if key in self._sampler_cache:
            return self._sampler_cache[key]
        net = self.velocity_net
        f32 = np.float32
        # times in fp32 as the JAX scan computes them: t0 = start + i * dt
        dt = f32((-1.0 if reverse else 1.0) / num_steps)
        start = f32(1.0 if reverse else 0.0)

        def vel(x: Tensor, t_scalar, extra: dict) -> Tensor:
            t = torch.full((x.shape[0],), float(t_scalar), dtype=torch.float32, device=x.device)
            return net(x.to(dtype), t, dtype=dtype, **extra).float()

        @torch.no_grad()
        def sampler(noise: Tensor, cond: Optional[Dict[str, Tensor]] = None):
            extra = {} if cond is None else {"cond": {k: c.to(dtype) for k, c in cond.items()}}
            x = noise.float()
            traj: List[Tensor] = []
            for i in range(num_steps):
                with annotate("rfv.sampler.step"):
                    t0 = start + f32(i) * dt
                    v = vel(x, t0, extra)
                    if method == "euler":
                        x = x + v * float(dt)
                    elif method == "midpoint":
                        x_mid = x + v * float(dt / f32(2))
                        x = x + vel(x_mid, t0 + dt / f32(2), extra) * float(dt)
                    else:  # heun
                        v2 = vel(x + v * float(dt), t0 + dt, extra)
                        x = x + (v + v2) * float(dt / f32(2))
                if return_trajectory:
                    traj.append(x)
            return (x, traj) if return_trajectory else x

        self._sampler_cache[key] = sampler
        return sampler

    def _noise(self, batch_size: int, generator: Optional[torch.Generator]) -> Tensor:
        shape = (batch_size, self.image_size, self.image_size, self.in_channels)
        return torch.randn(
            shape, generator=generator or self.generator, dtype=torch.float32,
            device=self.device,
        )

    def sample(
        self,
        noise=None,
        num_steps: int = 100,
        batch_size: int = 1,
        return_trajectory: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        data_format: str = "NCHW",
        dtype: Optional[str] = None,
        method: str = "euler",
        cond: Optional[Dict[str, Tensor]] = None,
    ):
        """Generate samples by ODE integration from ``noise`` (or from
        ``batch_size`` fresh noise images drawn from ``generator``, by
        default the model's seeded one). With ``return_trajectory`` the list
        [noise, x_1, ..., x_N] is returned. A conditional backbone takes
        ``cond``: its rows by name, one per image, on the model's device."""
        sample_dtype = _DTYPES[dtype] if dtype is not None else self.sample_dtype
        if noise is None:
            noise_nhwc = self._noise(batch_size, generator)
        else:
            noise_nhwc = _to_nhwc(noise, data_format, self.device).float()
        sampler = self._get_sampler(num_steps, return_trajectory, sample_dtype, method)
        if return_trajectory:
            _, traj = sampler(noise_nhwc, cond)
            return [_from_nhwc(s, data_format) for s in [noise_nhwc] + traj]
        return _from_nhwc(sampler(noise_nhwc, cond), data_format)

    def invert(
        self,
        images,
        num_steps: int = 100,
        *,
        data_format: str = "NCHW",
        dtype: Optional[str] = None,
        method: str = "euler",
    ) -> Tensor:
        """Integrate the flow ODE backward (t: 1 -> 0) from images to noise."""
        sample_dtype = _DTYPES[dtype] if dtype is not None else self.sample_dtype
        x = _to_nhwc(images, data_format, self.device).float()
        sampler = self._get_sampler(num_steps, False, sample_dtype, method, reverse=True)
        return _from_nhwc(sampler(x), data_format)

    def sample_with_trajectory(
        self, noise, num_steps: int = 100, save_every: int = 10, *, data_format: str = "NCHW"
    ) -> List[Tensor]:
        """Snapshots [x_0, x_{save_every}, x_{2*save_every}, ...]."""
        states = self.sample(
            noise, num_steps=num_steps, return_trajectory=True, data_format=data_format
        )
        return [states[0]] + [states[i] for i in range(save_every, num_steps + 1, save_every)]

    # ---- checkpointing ------------------------------------------------------

    def save(self, path: str) -> None:
        """Save params + full architecture config to one .npz file. While the
        network is placed on a mesh every rank must call it, and rank 0
        writes."""
        params = self.params
        if not mesh_lib.is_parallel(self) or mesh_lib.writes_files():
            ckpt_io.save_params(path, params, self.config)

    def load(self, path: str) -> None:
        """Load params from .npz (the JAX package's format) or a reference .pt."""
        params, _ = ckpt_io.load_params(path)
        self.params = params
        print(f"Model loaded from: {path}")

    @classmethod
    def from_checkpoint(cls, path: str, **overrides) -> "BaseFlowModel":
        """Rebuild a model from a self-describing checkpoint. The stored
        ``model_type`` dispatches, so a RectifiedFlowModel checkpoint loads
        as a RectifiedFlowModel with its ``reflow_iteration``."""
        params, config = ckpt_io.load_params(path)
        config = dict(config or {})
        model_type = config.pop("model_type", None)
        reflow_iteration = config.pop("reflow_iteration", None)
        config.update(overrides)
        target_cls = cls
        if model_type == "RectifiedFlowModel":
            from rectified_flow_vision_tpu_torch.models.rectified_flow import (
                RectifiedFlowModel,
            )

            target_cls = RectifiedFlowModel
        model = target_cls(**config)
        if reflow_iteration is not None and hasattr(model, "reflow_iteration"):
            model.reflow_iteration = int(reflow_iteration)
        model.params = params
        return model


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def sample_times(
    time_sampling: str, batch: int, generator: torch.Generator, device: torch.device
) -> Tensor:
    """``batch`` times in [0, 1], fp32, drawn on ``device``."""
    if time_sampling == "uniform":
        return torch.rand((batch,), generator=generator, dtype=torch.float32, device=device)
    if time_sampling == "logit_normal":
        z = torch.randn((batch,), generator=generator, dtype=torch.float32, device=device)
        return torch.sigmoid(z)
    if time_sampling == "u_shaped":
        # arcsine law: density 1/(pi*sqrt(t(1-t))), peaked at both ends
        u = torch.rand((batch,), generator=generator, dtype=torch.float32, device=device)
        return 0.5 - 0.5 * torch.cos(math.pi * u)
    raise ValueError(f"unknown time_sampling {time_sampling!r}")


def make_epoch_cosine_schedule(
    lr: float, epochs: int, steps_per_epoch: int, warmup_epochs: float = 0.0
) -> Callable[[int], float]:
    """Per-epoch cosine annealing, as torch CosineAnnealingLR stepped once
    per epoch: epoch e uses lr * (1 + cos(pi * e / epochs)) / 2.

    ``warmup_epochs`` > 0 prepends a linear per-step ramp from 0 to the
    scheduled lr across that many epochs. ``schedule(step)`` is computed on
    the host, in fp32 like the JAX schedule, from the step count starting at 0.
    """
    f32 = np.float32
    spe = max(steps_per_epoch, 1)

    def schedule(step: int) -> float:
        frac = min(f32(step // spe) / f32(epochs), f32(1.0))
        cos = f32(0.5 * lr) * (f32(1.0) + np.cos(f32(np.pi) * frac, dtype=f32))
        if warmup_epochs <= 0:
            return float(cos)
        ramp = min((f32(step) + f32(1.0)) / f32(warmup_epochs * spe), f32(1.0))
        return float(cos * ramp)

    return schedule


class FlowOptimizer:
    """Global-norm clip at 1.0, then AdamW (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 0.01 on every parameter) at the scheduled lr: the update of
    the JAX package's ``optax.chain(clip_by_global_norm(1.0), adamw(...))``.

    The clip scales by 1/norm only where norm >= 1, with nothing added to the
    denominator, on the device (no value is read back). The lr of step n is
    ``schedule(n)``, counted from 0 and set from the host.

    With ``mesh`` the norm is that of the whole gradient, as
    ``optax.clip_by_global_norm`` takes it over the global tree: squares
    summed over the data group where FSDP shards a parameter (a ``DTensor``)
    and over the model group where ``tp_split`` marks a tensor-parallel shard;
    a replicated parameter counts once.
    """

    def __init__(
        self, params: Sequence[Tensor], schedule: Callable[[int], float], *,
        mesh=None, tp_split: Optional[Sequence[bool]] = None,
    ) -> None:
        from torch.distributed.tensor import DTensor

        self.params = list(params)
        self.schedule = schedule
        self.step_count = 0
        self.mesh = mesh
        self.tp_split = list(tp_split) if tp_split is not None else [False] * len(self.params)
        self.sharded = any(isinstance(p, DTensor) for p in self.params)
        self.adamw = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
            fused=self.params[0].device.type == "cuda" and not self.sharded,
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _norm(self, grads: List[Tensor]) -> Tensor:
        if self.mesh is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        sq = torch.stack(torch._foreach_norm(grads)).square()
        split = torch.tensor(self.tp_split, device=sq.device)
        parts = torch.stack([sq[split].sum(), sq[~split].sum()])
        if self.sharded:
            dist.all_reduce(parts, group=mesh_lib.axis_group(self.mesh, mesh_lib.DATA_AXIS))
        if any(self.tp_split):
            split_sum = parts[:1].clone()
            dist.all_reduce(split_sum, group=mesh_lib.axis_group(self.mesh, mesh_lib.MODEL_AXIS))
            parts = torch.cat([split_sum, parts[1:]])
        return parts.sum().sqrt()

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("FlowOptimizer.step: a parameter has no gradient")
        if self.sharded:  # FSDP: each rank scales its shard
            grads = [g.to_local() for g in grads]
        norm = self._norm(grads)
        torch._foreach_mul_(grads, torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.step_count)
        self.adamw.step()
        self.step_count += 1

    def state_dict(self) -> Dict[str, Any]:
        """``step_count`` (the schedule's position) beside AdamW's state."""
        return {"step_count": self.step_count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore ``state_dict()``; AdamW moves its moments onto the
        parameters' device (and a fused AdamW its ``step`` counts too), and
        under FSDP they become shards like their parameters again."""
        self.step_count = int(state["step_count"])
        self.adamw.load_state_dict(state["adamw"])
        if self.sharded:
            for p in self.params:
                st = self.adamw.state[p]
                for k in ("exp_avg", "exp_avg_sq"):
                    st[k] = mesh_lib.like(st[k], p)


def make_optimizer(
    model: BaseFlowModel, lr: float, epochs: int, steps_per_epoch: int,
    warmup_epochs: float = 0.0,
    mesh=None,
) -> FlowOptimizer:
    """AdamW (torch-default hyperparameters) + epoch-cosine lr + grad clip 1.0
    over the model's parameters, as they are placed on ``mesh``."""
    schedule = make_epoch_cosine_schedule(lr, epochs, steps_per_epoch, warmup_epochs)
    named = list(model.named_parameters())
    tp_split = None
    if mesh is not None and mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS) > 1:
        tp_split = [mesh_lib.unet_param_spec(k, p.ndim).count(mesh_lib.MODEL_AXIS) > 0
                    for k, p in named]
    return FlowOptimizer([p for _, p in named], schedule, mesh=mesh, tp_split=tp_split)


def init_ema(model: BaseFlowModel) -> Dict[str, Tensor]:
    """A copy of the model's current parameters, by state-dict name (this
    rank's shards on a mesh)."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def ema_params(ema: Dict[str, Tensor], backbone: str = "unet", model=None) -> Params:
    """EMA weights as a param tree, for ``checkpoint.save_params``. Shards on
    a mesh are gathered in ``model``'s layout (every rank must call it)."""
    if model is not None and mesh_lib.is_parallel(model):
        ema = mesh_lib.full_tensors(model, ema)
    sd = {k: v.cpu().numpy() for k, v in ema.items()}
    return pt_import.backbone_state_dict_to_params(sd, backbone)


def make_train_step(
    model: BaseFlowModel,
    opt: FlowOptimizer,
    *,
    coupled: bool,
    ema: Optional[Dict[str, Tensor]] = None,
    ema_decay: Optional[float] = None,
    time_sampling: str = "uniform",
    mesh=None,
) -> Callable[[Any, torch.Generator], Tensor]:
    """Build ``train_step(batch, generator) -> loss``: loss -> grad ->
    global-norm clip -> AdamW update, in place. ``batch`` is x1 (NHWC on the
    device), or ``(x0, x1)`` when ``coupled``. With ``ema`` (from
    ``init_ema``) and ``ema_decay``, the moving average e*d + p*(1-d) of the
    updated parameters is kept in ``ema``. The loss comes back on the device,
    detached; nothing is read to the host.

    With ``mesh`` (the model placed on it, ``mesh_lib.place_params``, and
    ``opt`` made for it) ``batch`` is this rank's rows of the global batch:
    the gradients are averaged over ``data`` (FSDP's own reduce-scatter does
    it under FSDP) and the loss returned is the global batch's. A one-device
    mesh runs the same collectives, so their cost shows.
    """
    model._no_flux("make_train_step")
    if (ema is None) != (ema_decay is None):
        raise ValueError("ema and ema_decay go together")
    if ema is not None:
        d = float(ema_decay)
        named = dict(model.named_parameters())
        ema_list = [ema[k] for k in named]
        live = [p.detach() for p in named.values()]

    if ema is not None and any(mesh_lib.is_dtensor(e) for e in ema_list):
        ema_list, live = [e.to_local() for e in ema_list], [p.to_local() for p in live]
    average = mesh is not None and not getattr(model.velocity_net, "fsdp", False)

    def train_step(batch, generator: torch.Generator) -> Tensor:
        x0, x1 = batch if coupled else (None, batch)
        with annotate("rfv.train.step"):
            opt.zero_grad()
            with annotate("rfv.train.loss"):
                loss = model.loss_fn(x1, generator, x0=x0, train=True,
                                     time_sampling=time_sampling, mesh=mesh)
            with annotate("rfv.train.backward"):
                loss.backward()
                if average:
                    mesh_lib.average_grads(mesh, opt.params)
            with annotate("rfv.train.optimizer"):
                opt.step()
            if ema is not None:
                with annotate("rfv.train.ema"):
                    torch._foreach_mul_(ema_list, d)
                    torch._foreach_add_(ema_list, live, alpha=1.0 - d)
            loss = loss.detach()
            return loss if mesh is None else mesh_lib.data_mean(mesh, loss)

    return train_step


def make_train_epoch(
    model: BaseFlowModel,
    opt: FlowOptimizer,
    *,
    coupled: bool,
    ema: Optional[Dict[str, Tensor]] = None,
    ema_decay: Optional[float] = None,
    time_sampling: str = "uniform",
    mesh=None,
) -> Callable[[Any, Tensor, torch.Generator], Tensor]:
    """Build ``train_epoch(corpus, perm, generator) -> losses [steps]``.

    The corpus ([N, H, W, C], or an (x0, x1) pair of those when ``coupled``)
    lives on the device; each step gathers its batch there by a row of
    ``perm`` ([steps, B] indices on the device). The host only enqueues: the
    step losses stay on the device, for the caller to read once per epoch.
    Step math and random draws are those of ``make_train_step``, so the
    trajectory equals the per-step path's. With ``mesh`` every rank holds the
    corpus and the same ``perm`` and gathers its rows of each global batch.
    """
    step = make_train_step(
        model, opt, coupled=coupled, ema=ema, ema_decay=ema_decay, time_sampling=time_sampling,
        mesh=mesh,
    )

    def train_epoch(corpus, perm: Tensor, generator: torch.Generator) -> Tensor:
        losses = []
        for idx in perm:
            with annotate("rfv.train.gather"):
                if mesh is not None:
                    idx = mesh_lib.shard_batch(mesh, idx)
                if coupled:
                    batch = (corpus[0].index_select(0, idx), corpus[1].index_select(0, idx))
                else:
                    batch = corpus.index_select(0, idx)
            losses.append(step(batch, generator))
        return torch.stack(losses)

    return train_epoch


# corpora larger than this stay on the host per-step path (the device epoch
# keeps the whole corpus in device memory)
DEVICE_EPOCH_MAX_BYTES = 2 * 1024**3


def place_for_training(model: BaseFlowModel, mesh, fsdp: bool, batch_size: Optional[int]):
    """The trainers' placement: the model's parameters on ``mesh`` (FSDP when
    ``fsdp``, else tensor parallel / replicated); the global batch must split
    over ``data``. Returns the effective mesh (None for no or a one-device
    mesh)."""
    mesh = mesh_lib.effective_mesh(mesh)
    if mesh is None:
        return None
    dp = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
    if batch_size is not None and batch_size % dp:
        raise ValueError(f"batch_size {batch_size} does not split over {dp} data ranks")
    mesh_lib.place_params(mesh, model, fsdp=fsdp)
    return mesh


def restore_train_state(
    resume_dir: str, model: BaseFlowModel, opt: FlowOptimizer, use_ema: bool, what: str,
    mesh=None,
):
    """The resume of both trainers: open ``resume_dir``'s ``TrainStateManager``
    and load its latest state, if any, into ``model`` and ``opt`` in place.
    On a mesh each rank keeps its own shards' state, in ``resume_dir/rankR_of_N``
    (a run resumes on a mesh of the same shape).

    Returns ``(manager, losses, start_epoch, ema)``. A restored EMA is dropped
    when ``use_ema`` is off (a run that had one resumed without); None means
    the caller seeds a fresh EMA from the current, possibly restored, params.
    """
    from rectified_flow_vision_tpu_torch.utils.train_state import TrainStateManager

    if mesh is not None:
        resume_dir = f"{resume_dir}/rank{dist.get_rank()}_of_{dist.get_world_size()}"
    mgr = TrainStateManager(resume_dir)
    restored = mgr.restore()
    if restored is None:
        return mgr, [], 0, None
    params, opt_state, losses, start_epoch, ema = restored
    named = dict(model.named_parameters())
    if mesh is None:
        model.load_state_dict(params)
    else:
        with torch.no_grad():
            for k, p in named.items():
                mesh_lib.local(p).copy_(params[k])
    opt.load_state_dict(opt_state)
    log.info("Resumed %s training from epoch %d (%s)", what, start_epoch, resume_dir)
    if not use_ema or ema is None:
        return mgr, losses, start_epoch, None
    return mgr, losses, start_epoch, {
        k: mesh_lib.like(v.to(model.device), named[k]) for k, v in ema.items()
    }


def save_train_state(state_mgr, epoch: int, model: BaseFlowModel, opt: FlowOptimizer,
                     losses: List[float], ema) -> None:
    """The trainers' state save: this rank's (local) tensors."""
    local = mesh_lib.local_tree
    state_mgr.save(epoch, local(dict(model.named_parameters())), local(opt.state_dict()),
                   losses, ema=local(ema))


def epoch_generator(model: BaseFlowModel, seed: int, epoch: int) -> torch.Generator:
    """The generator of one training epoch: noise, times and dropout seeds of
    its steps are drawn from it in order."""
    return torch.Generator(device=model.device).manual_seed(seed * 1000003 + epoch)


def save_epoch_checkpoints(
    model: BaseFlowModel, ema: Optional[Dict[str, Tensor]], save_path: str, tag: str, ext: str
) -> None:
    """``<save_path>_<tag><ext>`` and, with an EMA, ``<save_path>_ema_<tag><ext>``:
    whole weights, written by rank 0 of a process group once every rank has
    gathered them; every rank returns when the files are written."""
    params = model.params
    ema_tree = ema_params(ema, model.backbone, model) if ema is not None else None
    if mesh_lib.writes_files():
        ckpt_io.save_params(f"{save_path}_{tag}{ext}", params, model.config)
        if ema_tree is not None:
            ckpt_io.save_params(f"{save_path}_ema_{tag}{ext}", ema_tree, model.config)
    mesh_lib.barrier()


def train_base_flow(
    model: BaseFlowModel,
    dataloader,
    epochs: int = 50,
    lr: float = 1e-4,
    save_path: Optional[str] = None,
    save_every: int = 10,
    *,
    batch_size: Optional[int] = None,
    mesh=None,
    seed: int = 0,
    ckpt_ext: str = ".npz",
    progress: bool = True,
    resume_dir: Optional[str] = None,
    use_native_loader: bool = False,
    ema_decay: Optional[float] = None,
    device_epoch: Optional[bool] = None,
    fsdp: bool = False,
    warmup_epochs: float = 0.0,
) -> List[float]:
    """Train the base flow model; returns the per-epoch mean losses.

    ``dataloader`` may be a dataset (``batches`` / ``num_batches``, e.g.
    ``ImageDataset``; reshuffled per epoch with a per-epoch seed; requires
    ``batch_size``) or any re-iterable of NHWC numpy batches. With
    ``ema_decay`` an EMA of the weights is carried and written beside each
    checkpoint as ``*_ema_*``. ``device_epoch`` (the default off the CPU when
    the corpus fits and no native loader runs) keeps the corpus on the device
    and reads the losses once per epoch. ``use_native_loader`` takes the
    dataset's C++ prefetching loader (``data/native_loader.py``); without its
    library it logs a warning and uses Python batches, as the JAX trainer
    does. With ``resume_dir`` the full train state (weights, optimizer and
    schedule, losses, EMA) is saved there every ``save_every`` epochs and at
    the end, and a run restarts from the latest saved epoch: epoch ``k``
    draws from its own generator and permutation, so a resumed run repeats
    the uninterrupted one.

    ``mesh`` (``parallel.mesh.create_mesh``; every rank calls the trainer
    with the same arguments) trains data parallel over ``data`` and tensor
    parallel over ``model``, or with ``fsdp`` fully sharded over ``data``;
    each rank takes its rows of every global batch of ``batch_size``. The
    losses are the global batches'. On return the model holds the whole
    trained weights again on every rank. A one-device mesh is no mesh.
    """
    device = model.device
    is_dataset = hasattr(dataloader, "batches") and hasattr(dataloader, "num_batches")
    native = None
    if is_dataset:
        if batch_size is None:
            raise ValueError("batch_size is required when passing an ImageDataset")
        steps_per_epoch = dataloader.num_batches(batch_size)
        if use_native_loader:
            native = dataloader.native_loader(batch_size, seed=seed)
            if native is None:
                log.warning(
                    "native loader requested but unavailable "
                    "(build with tools/build_native.sh); using Python batches"
                )
            else:
                steps_per_epoch = native.batches_per_epoch
    else:
        # generic iterable: materialize once, then reshuffle the batch list
        # per epoch (seeded), as a DataLoader with shuffle=True would
        dataloader = list(dataloader)
        steps_per_epoch = len(dataloader)
    if steps_per_epoch == 0:
        raise ValueError("empty dataloader")

    mesh = place_for_training(model, mesh, fsdp, batch_size if is_dataset else None)
    opt = make_optimizer(model, lr, epochs, steps_per_epoch, warmup_epochs, mesh=mesh)
    use_ema = ema_decay is not None and ema_decay > 0
    state_mgr, losses, start_epoch, ema = None, [], 0, None
    if resume_dir is not None:
        state_mgr, losses, start_epoch, ema = restore_train_state(
            resume_dir, model, opt, use_ema, "base flow", mesh)
    if use_ema and ema is None:
        ema = init_ema(model)
    step_kwargs = dict(coupled=False, ema=ema, ema_decay=ema_decay if use_ema else None,
                       mesh=mesh)

    corpus_host = getattr(dataloader, "images", None) if is_dataset else None
    if device_epoch is None:
        device_epoch = (
            native is None
            and corpus_host is not None
            and 0 < len(dataloader)
            and corpus_host.nbytes <= DEVICE_EPOCH_MAX_BYTES
            and device.type != "cpu"
        )
    if device_epoch and corpus_host is None:
        raise ValueError("device_epoch=True needs a dataset with .images")
    if device_epoch:
        corpus_dev = torch.as_tensor(corpus_host, dtype=torch.float32, device=device)
        train_epoch = make_train_epoch(model, opt, **step_kwargs)  # every rank holds the corpus
    else:
        train_step = make_train_step(model, opt, **step_kwargs)

    for epoch in range(start_epoch, epochs):
        gen = epoch_generator(model, seed, epoch)
        t0 = time.time()
        if device_epoch:
            # the permutation of ImageDataset.batches
            n = len(dataloader)
            idx = np.arange(n)
            np.random.default_rng(seed * 100003 + epoch).shuffle(idx)
            if n < batch_size:
                idx = np.tile(idx, -(-batch_size // n))[:batch_size]
                n = batch_size
            end = n - (n % batch_size)
            perm = torch.as_tensor(idx[:end].reshape(-1, batch_size), device=device)
            avg_loss = float(train_epoch(corpus_dev, perm, gen).mean())
        else:
            if native is not None:
                batches = native.epoch(epoch)
            elif is_dataset:
                batches = dataloader.batches(batch_size, seed=seed * 100003 + epoch)
            else:
                order = np.random.default_rng(seed * 100003 + epoch).permutation(
                    len(dataloader)
                )
                batches = (dataloader[j] for j in order)
            step_losses = [
                train_step(mesh_lib.shard_batch(mesh, torch.as_tensor(
                    np.asarray(b), dtype=torch.float32, device=device)), gen)
                for b in batches
            ]
            avg_loss = float(torch.stack(step_losses).mean())
        losses.append(avg_loss)
        if progress:
            log.info(
                "Epoch %d/%d - Loss: %.4f (%.1fs)", epoch + 1, epochs, avg_loss,
                time.time() - t0,
            )
        if save_path and (epoch + 1) % save_every == 0:
            save_epoch_checkpoints(model, ema, save_path, f"epoch{epoch + 1}", ckpt_ext)
        if state_mgr is not None and (epoch + 1) % save_every == 0:
            save_train_state(state_mgr, epoch, model, opt, losses, ema)

    if native is not None:
        native.close()
    if save_path:
        save_epoch_checkpoints(model, ema, save_path, "final", ckpt_ext)
    if state_mgr is not None:
        close_train_state(state_mgr, model, opt, losses, ema, start_epoch, epochs)
    mesh_lib.unshard(model)
    return losses


def close_train_state(state_mgr, model, opt, losses, ema, start_epoch: int, epochs: int) -> None:
    """The trainers' last state save (when this run trained an epoch), then
    wait for it to be committed."""
    if epochs > start_epoch:
        save_train_state(state_mgr, epochs - 1, model, opt, losses, ema)
    state_mgr.close()

"""Flow-matching base model: the velocity field (UNet or DiT), flow math,
samplers and training.

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
  sampler; a Python loop takes the place of ``lax.scan``;
* checkpoints: the same ``.npz`` (param tree + ``__config__``) as the JAX
  package, and reference ``.pt`` files.

``BaseFlowModel`` is an ``nn.Module`` whose only child is ``velocity_net``,
so its ``state_dict`` has the reference checkpoint's ``velocity_net.`` keys.
It lives on ``device`` ("cuda" by default; "cpu" only when asked for). The
public tensor API takes and returns NCHW by default, like the JAX package;
pass ``data_format="NHWC"`` to stay in the internal layout.

Randomness is explicit: the loss draws noise, times and dropout seeds from a
``torch.Generator`` on the model's device (or takes them as arguments), and
the trainers seed one generator per epoch, so a seed fixes the trajectory.
Resume and meshes come with later slices.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rectified_flow_vision_tpu_torch.models.dit import DiT
from rectified_flow_vision_tpu_torch.models.unet import UNet, count_parameters
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt_io
from rectified_flow_vision_tpu_torch.utils import pt_import
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger

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
    """Flow-matching model: a UNet or DiT velocity field + flow math + sampler."""

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
        seed: int = 0,
        params: Optional[Params] = None,
        compute_dtype: str = "float32",
        sample_dtype: str = "bfloat16",
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        if backbone not in ("unet", "dit"):
            raise ValueError(f"unknown backbone {backbone!r} (unet|dit)")
        self.remat = bool(remat)
        self.image_size = image_size
        self.in_channels = in_channels
        self.backbone = backbone
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.sample_dtype = _DTYPES[sample_dtype]
        if backbone == "dit":
            self.velocity_net = DiT(
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
        else:
            self.velocity_net = UNet(
                in_channels=in_channels,
                model_channels=model_channels,
                out_channels=in_channels,
                channel_mult=channel_mult,
                num_res_blocks=num_res_blocks,
                attention_resolutions=attention_resolutions,
                dropout=dropout,
            )
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

    @property
    def params(self) -> Params:
        """The weights as the JAX package's param tree (numpy, HWIO / (in, out))."""
        sd = {k: v.detach().cpu().numpy() for k, v in self.state_dict().items()}
        return pt_import.backbone_state_dict_to_params(sd, self.backbone)

    @params.setter
    def params(self, tree: Params) -> None:
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
        """
        gen = generator if generator is not None else self.generator
        net = self.velocity_net
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=gen, dtype=x1.dtype, device=x1.device)
        if t is None:
            t = sample_times(time_sampling, x1.shape[0], gen, x1.device)
        unet = self.backbone == "unet"
        if unet and seeds is None and train and net.dropout > 0:
            seeds = torch.randint(
                2**31 - 1, (net.num_dropout_seeds,), generator=gen, dtype=torch.int32,
                device=x1.device,
            )
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
    def forward(self, x, t, data_format: str = "NCHW") -> Tensor:
        """The velocity field v(x, t), computed in ``compute_dtype``."""
        x = _to_nhwc(x, data_format, self.device)
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device).reshape(-1)
        return _from_nhwc(self.velocity_net(x, t, dtype=self.compute_dtype), data_format)

    def _get_sampler(
        self,
        num_steps: int,
        return_trajectory: bool,
        dtype: torch.dtype,
        method: str = "euler",
        reverse: bool = False,
    ) -> Callable[[Tensor], Any]:
        """``sampler(noise_nhwc) -> x`` (or ``(x, [x_1..x_N])``), cached per
        (steps, trajectory, dtype, method, direction)."""
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

        def vel(x: Tensor, t_scalar) -> Tensor:
            t = torch.full((x.shape[0],), float(t_scalar), dtype=torch.float32, device=x.device)
            return net(x.to(dtype), t, dtype=dtype).float()

        @torch.no_grad()
        def sampler(noise: Tensor):
            x = noise.float()
            traj: List[Tensor] = []
            for i in range(num_steps):
                t0 = start + f32(i) * dt
                v = vel(x, t0)
                if method == "euler":
                    x = x + v * float(dt)
                elif method == "midpoint":
                    x_mid = x + v * float(dt / f32(2))
                    x = x + vel(x_mid, t0 + dt / f32(2)) * float(dt)
                else:  # heun
                    v2 = vel(x + v * float(dt), t0 + dt)
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
    ):
        """Generate samples by ODE integration from ``noise`` (or from
        ``batch_size`` fresh noise images drawn from ``generator``, by
        default the model's seeded one). With ``return_trajectory`` the list
        [noise, x_1, ..., x_N] is returned."""
        sample_dtype = _DTYPES[dtype] if dtype is not None else self.sample_dtype
        if noise is None:
            noise_nhwc = self._noise(batch_size, generator)
        else:
            noise_nhwc = _to_nhwc(noise, data_format, self.device).float()
        sampler = self._get_sampler(num_steps, return_trajectory, sample_dtype, method)
        if return_trajectory:
            _, traj = sampler(noise_nhwc)
            return [_from_nhwc(s, data_format) for s in [noise_nhwc] + traj]
        return _from_nhwc(sampler(noise_nhwc), data_format)

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
        """Save params + full architecture config to one .npz file."""
        ckpt_io.save_params(path, self.params, self.config)

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
    """

    def __init__(self, params: Sequence[Tensor], schedule: Callable[[int], float]) -> None:
        self.params = list(params)
        self.schedule = schedule
        self.step_count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
            fused=self.params[0].device.type == "cuda",
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("FlowOptimizer.step: a parameter has no gradient")
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.step_count)
        self.adamw.step()
        self.step_count += 1


def make_optimizer(
    model: BaseFlowModel, lr: float, epochs: int, steps_per_epoch: int,
    warmup_epochs: float = 0.0,
) -> FlowOptimizer:
    """AdamW (torch-default hyperparameters) + epoch-cosine lr + grad clip 1.0
    over the model's parameters."""
    schedule = make_epoch_cosine_schedule(lr, epochs, steps_per_epoch, warmup_epochs)
    return FlowOptimizer(list(model.parameters()), schedule)


def init_ema(model: BaseFlowModel) -> Dict[str, Tensor]:
    """A copy of the model's current parameters, by state-dict name."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def ema_params(ema: Dict[str, Tensor], backbone: str = "unet") -> Params:
    """EMA weights as a param tree, for ``checkpoint.save_params``."""
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
) -> Callable[[Any, torch.Generator], Tensor]:
    """Build ``train_step(batch, generator) -> loss``: loss -> grad ->
    global-norm clip -> AdamW update, in place. ``batch`` is x1 (NHWC on the
    device), or ``(x0, x1)`` when ``coupled``. With ``ema`` (from
    ``init_ema``) and ``ema_decay``, the moving average e*d + p*(1-d) of the
    updated parameters is kept in ``ema``. The loss comes back on the device,
    detached; nothing is read to the host.
    """
    if (ema is None) != (ema_decay is None):
        raise ValueError("ema and ema_decay go together")
    if ema is not None:
        d = float(ema_decay)
        named = dict(model.named_parameters())
        ema_list = [ema[k] for k in named]
        live = [p.detach() for p in named.values()]

    def train_step(batch, generator: torch.Generator) -> Tensor:
        x0, x1 = batch if coupled else (None, batch)
        opt.zero_grad()
        loss = model.loss_fn(x1, generator, x0=x0, train=True, time_sampling=time_sampling)
        loss.backward()
        opt.step()
        if ema is not None:
            torch._foreach_mul_(ema_list, d)
            torch._foreach_add_(ema_list, live, alpha=1.0 - d)
        return loss.detach()

    return train_step


def make_train_epoch(
    model: BaseFlowModel,
    opt: FlowOptimizer,
    *,
    coupled: bool,
    ema: Optional[Dict[str, Tensor]] = None,
    ema_decay: Optional[float] = None,
    time_sampling: str = "uniform",
) -> Callable[[Any, Tensor, torch.Generator], Tensor]:
    """Build ``train_epoch(corpus, perm, generator) -> losses [steps]``.

    The corpus ([N, H, W, C], or an (x0, x1) pair of those when ``coupled``)
    lives on the device; each step gathers its batch there by a row of
    ``perm`` ([steps, B] indices on the device). The host only enqueues: the
    step losses stay on the device, for the caller to read once per epoch.
    Step math and random draws are those of ``make_train_step``, so the
    trajectory equals the per-step path's.
    """
    step = make_train_step(
        model, opt, coupled=coupled, ema=ema, ema_decay=ema_decay, time_sampling=time_sampling
    )

    def train_epoch(corpus, perm: Tensor, generator: torch.Generator) -> Tensor:
        losses = []
        for idx in perm:
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


def reject_unported(**options) -> None:
    """Raise for a trainer option whose module is not ported yet, naming the
    ROADMAP item that holds it."""
    items = {
        "mesh": "A9 (parallelism)",
        "fsdp": "A9 (parallelism)",
        "resume_dir": "A7 (checkpoint, resume)",
    }
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported to PyTorch yet: ROADMAP.md item {items[name]}"
            )


def epoch_generator(model: BaseFlowModel, seed: int, epoch: int) -> torch.Generator:
    """The generator of one training epoch: noise, times and dropout seeds of
    its steps are drawn from it in order."""
    return torch.Generator(device=model.device).manual_seed(seed * 1000003 + epoch)


def save_epoch_checkpoints(
    model: BaseFlowModel, ema: Optional[Dict[str, Tensor]], save_path: str, tag: str, ext: str
) -> None:
    """``<save_path>_<tag><ext>`` and, with an EMA, ``<save_path>_ema_<tag><ext>``."""
    model.save(f"{save_path}_{tag}{ext}")
    if ema is not None:
        ckpt_io.save_params(
            f"{save_path}_ema_{tag}{ext}", ema_params(ema, model.backbone), model.config
        )


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
    does. ``mesh``, ``fsdp`` and ``resume_dir`` are not ported yet and raise.
    """
    reject_unported(mesh=mesh, fsdp=fsdp, resume_dir=resume_dir)
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

    opt = make_optimizer(model, lr, epochs, steps_per_epoch, warmup_epochs)
    use_ema = ema_decay is not None and ema_decay > 0
    ema = init_ema(model) if use_ema else None
    step_kwargs = dict(coupled=False, ema=ema, ema_decay=ema_decay if use_ema else None)

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
        train_epoch = make_train_epoch(model, opt, **step_kwargs)
    else:
        train_step = make_train_step(model, opt, **step_kwargs)

    losses: List[float] = []
    for epoch in range(epochs):
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
                train_step(torch.as_tensor(np.asarray(b), dtype=torch.float32, device=device), gen)
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

    if native is not None:
        native.close()
    if save_path:
        save_epoch_checkpoints(model, ema, save_path, "final", ckpt_ext)
    return losses

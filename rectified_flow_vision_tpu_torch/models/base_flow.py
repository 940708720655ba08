"""Flow-matching base model: the UNet velocity field, flow math and samplers.

Counterpart of the JAX package's ``models/base_flow.py`` (inference part):

* path: x_t = (1-t) x0 + t x1, target velocity x1 - x0;
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
pass ``data_format="NHWC"`` to stay in the internal layout. Training comes
with a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rectified_flow_vision_tpu_torch.models.unet import UNet, count_parameters
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt_io
from rectified_flow_vision_tpu_torch.utils import pt_import

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
    """Flow-matching model: a UNet velocity field + flow math + sampler."""

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
        seed: int = 0,
        params: Optional[Params] = None,
        compute_dtype: str = "float32",
        sample_dtype: str = "bfloat16",
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        if backbone != "unet":
            raise ValueError(f"backbone {backbone!r} is not ported yet (unet)")
        self.image_size = image_size
        self.in_channels = in_channels
        self.backbone = backbone
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.sample_dtype = _DTYPES[sample_dtype]
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
        return {
            "model_type": type(self).__name__,
            "image_size": self.image_size,
            "in_channels": self.in_channels,
            "backbone": self.backbone,
            "model_channels": n.model_channels,
            "channel_mult": list(n.channel_mult),
            "num_res_blocks": n.num_res_blocks,
            "attention_resolutions": list(n.attention_resolutions),
            "dropout": n.dropout,
        }

    def num_parameters(self) -> int:
        return count_parameters(self)

    @property
    def params(self) -> Params:
        """The weights as the JAX package's param tree (numpy, HWIO / (in, out))."""
        sd = {k: v.detach().cpu().numpy() for k, v in self.state_dict().items()}
        return pt_import.state_dict_to_params(sd)[0]

    @params.setter
    def params(self, tree: Params) -> None:
        n = self.velocity_net
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

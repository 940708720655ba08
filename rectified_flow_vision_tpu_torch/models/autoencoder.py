"""Convolutional VAE: pixel space <-> latent space for the DiT-256 config.

Counterpart of the JAX package's ``models/autoencoder.py``. A small
KL-regularised autoencoder maps 256x256x3 images to 64x64x4 latents (4x
spatial downsample); the rectified-flow DiT trains and samples in latent
space and the decoder maps generated latents back to pixels. Latents are
scaled by a calibration factor (1 / std of the trained encoder's output) so
the flow model sees about unit-variance data.

``ConvVAE`` is an ``nn.Module`` named after the JAX param tree
(``enc.in``, ``enc.down{i}.{conv,norm}``, ``enc.out_norm``, ``enc.out`` and
the same under ``dec`` with ``up{i}``), so a ``.npz`` written by either
package loads into the other. Tensors are NHWC. Every GroupNorm + SiLU goes
through ``fused.gn_silu`` and every conv through ``fused.conv2d_fused``: on
a CUDA tensor the port's kernels (the GroupNorm's slabs, larger than one
cluster holds, on its streamed plan; the convs inside ``conv3x3.supports``
on ``conv3x3``), the plain conv outside that contract, and on the CPU the
plain versions, which round as the JAX package's primitives
(``P.silu(P.group_norm(...))``, ``P.conv2d``). Noise is
explicit: a ``torch.Generator`` on the module's device, or a given ``eps``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rectified_flow_vision_tpu_torch.models.base_flow import (
    _DTYPES,
    Params,
    _from_nhwc,
    resolve_device,
)
from rectified_flow_vision_tpu_torch.models.unet import _ParamCache, _View
from rectified_flow_vision_tpu_torch.ops import primitives as P
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt_io
from rectified_flow_vision_tpu_torch.utils import pt_import

Tensor = torch.Tensor

NUM_GROUPS = 8


class _Level(nn.Module):
    """One resolution step: GroupNorm + SiLU on ``in_ch``, then a 3x3 conv."""

    def __init__(self, in_ch: int, out_ch: int, stride: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1)
        self.norm = nn.GroupNorm(NUM_GROUPS, in_ch)


class ConvVAE(nn.Module):
    """Small KL autoencoder. ``downsample``x spatial reduction, ``latent_channels`` out."""

    def __init__(
        self,
        image_size: int = 256,
        in_channels: int = 3,
        latent_channels: int = 4,
        base_channels: int = 64,
        downsample: int = 4,  # spatial factor (power of 2)
        scaling_factor: float = 1.0,
        *,
        seed: int = 0,
        params: Optional[Params] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        if downsample & (downsample - 1):
            raise ValueError("downsample must be a power of 2")
        self.image_size = image_size
        self.in_channels = in_channels
        self.latent_channels = latent_channels
        self.base_channels = base_channels
        self.downsample = downsample
        self.num_levels = int(math.log2(downsample))
        self.scaling_factor = float(scaling_factor)
        self.device = resolve_device(device)

        c = base_channels
        enc = {"in": nn.Conv2d(in_channels, c, 3, padding=1)}
        ch = c
        for lv in range(self.num_levels):
            nxt = min(ch * 2, 4 * c)
            enc[f"down{lv}"] = _Level(ch, nxt, stride=2)
            ch = nxt
        enc["out_norm"] = nn.GroupNorm(NUM_GROUPS, ch)
        enc["out"] = nn.Conv2d(ch, 2 * latent_channels, 3, padding=1)
        dec = {"in": nn.Conv2d(latent_channels, ch, 3, padding=1)}
        for lv in range(self.num_levels):
            nxt = max(ch // 2, c)
            dec[f"up{lv}"] = _Level(ch, nxt, stride=1)
            ch = nxt
        dec["out_norm"] = nn.GroupNorm(NUM_GROUPS, ch)
        dec["out"] = nn.Conv2d(ch, in_channels, 3, padding=1)
        self.enc = nn.ModuleDict(enc)
        self.dec = nn.ModuleDict(dec)
        self._params = _ParamCache()
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if params is not None:
            self.params = params

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Torch-default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for conv
        weights and biases, ones / zeros for GroupNorm, drawn in module order
        from ``generator`` on the CPU."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                    p.copy_((u * (2 * bound) - bound).to(p.device))
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)

    @property
    def latent_size(self) -> int:
        return self.image_size // self.downsample

    @property
    def config(self) -> dict:
        return {
            "model_type": "ConvVAE",
            "image_size": self.image_size,
            "in_channels": self.in_channels,
            "latent_channels": self.latent_channels,
            "base_channels": self.base_channels,
            "downsample": self.downsample,
            "scaling_factor": self.scaling_factor,
        }

    @property
    def params(self) -> Params:
        """The weights as the JAX package's param tree (numpy, HWIO)."""
        sd = {k: t.detach().cpu().numpy() for k, t in self.state_dict().items()}
        return pt_import.state_dict_to_tree(sd)

    @params.setter
    def params(self, tree: Params) -> None:
        sd = pt_import.tree_to_state_dict(tree)
        self.load_state_dict(
            {k: torch.from_numpy(np.array(a, np.float32)) for k, a in sd.items()}, strict=True
        )

    # ---- forward -----------------------------------------------------------

    def _noise(self, like: Tensor, generator: Optional[torch.Generator], eps) -> Tensor:
        if eps is not None:
            return torch.as_tensor(eps, dtype=like.dtype, device=like.device)
        return torch.randn(
            like.shape, generator=generator or self.generator, dtype=like.dtype,
            device=like.device,
        )

    def _encode_raw(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """x: [B, H, W, C] in [-1, 1] -> (mu, logvar), each [B, h, w, latent]."""
        v = _View(self._params, x.dtype, masters=True)
        e = self.enc
        h = v.conv3x3(x, e["in"])
        for lv in range(self.num_levels):
            h = v.gn_silu(h, e[f"down{lv}"].norm)
            h = v.conv3x3(h, e[f"down{lv}"].conv)
        h = v.gn_silu(h, e["out_norm"])
        mu, logvar = v.conv3x3(h, e["out"]).chunk(2, dim=-1)
        return mu, torch.clamp(logvar, -30.0, 20.0)

    def encode(
        self,
        x: Tensor,
        generator: Optional[torch.Generator] = None,
        *,
        eps=None,
    ) -> Tensor:
        """Deterministic (mu) latents, or sampled ones given a ``generator`` or
        the noise ``eps`` itself; scaled for the flow model."""
        mu, logvar = self._encode_raw(x)
        z = mu
        if eps is not None or generator is not None:
            z = mu + torch.exp(0.5 * logvar) * self._noise(mu, generator, eps)
        return z * self.scaling_factor

    def decode(self, z: Tensor, *, dtype: Optional[torch.dtype] = None) -> Tensor:
        """Scaled latents [B, h, w, latent] -> images [B, H, W, C] in about
        [-1, 1]. With ``dtype`` the latents and detached copies of the
        parameters are rounded through it first (the serving decode)."""
        v = _View(self._params, dtype or z.dtype, masters=dtype is None)
        d = self.dec
        h = v.conv3x3(z.to(v.dtype) / self.scaling_factor, d["in"])
        for lv in range(self.num_levels):
            h = v.gn_silu(h, d[f"up{lv}"].norm)
            h = P.upsample_nearest_2x(h)
            h = v.conv3x3(h, d[f"up{lv}"].conv)
        h = v.gn_silu(h, d["out_norm"])
        return v.conv3x3(h, d["out"])

    def apply(
        self, x: Tensor, generator: Optional[torch.Generator] = None, *, eps=None
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """(reconstruction, mu, logvar): the training forward."""
        mu, logvar = self._encode_raw(x)
        z = mu + torch.exp(0.5 * logvar) * self._noise(mu, generator, eps)
        # decode() divides by scaling_factor; pre-scale so training runs on
        # the raw (uncalibrated) latents
        return self.decode(z * self.scaling_factor), mu, logvar

    # ---- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        ckpt_io.save_params(path, self.params, self.config)

    @classmethod
    def load(cls, path: str, *, device: str | torch.device = "cuda") -> "ConvVAE":
        """Rebuild a VAE, weights and scaling factor, from its ``.npz``."""
        params, config = ckpt_io.load_params(path)
        return cls(
            image_size=int(config["image_size"]),
            in_channels=int(config["in_channels"]),
            latent_channels=int(config["latent_channels"]),
            base_channels=int(config["base_channels"]),
            downsample=int(config["downsample"]),
            scaling_factor=float(config["scaling_factor"]),
            params=params,
            device=device,
        )


def vae_loss(
    vae: ConvVAE, x: Tensor, kl_weight: float, generator: Optional[torch.Generator] = None,
    *, eps=None,
) -> Tuple[Tensor, Tensor]:
    """(reconstruction MSE + kl_weight * KL, reconstruction MSE)."""
    recon, mu, logvar = vae.apply(x, generator, eps=eps)
    mse = torch.mean(torch.square(recon.float() - x))
    kl = -0.5 * torch.mean(1 + logvar - mu**2 - torch.exp(logvar))
    return mse + kl_weight * kl, mse


def make_vae_optimizer(vae: ConvVAE, lr: float, total_steps: int):
    """``optax.adamw(cosine_decay_schedule(lr, total_steps))`` in PyTorch:
    AdamW with weight decay 1e-4 and eps 1e-8, no gradient clip, and a cosine
    to zero that advances with every optimizer step. Returns
    ``(optimizer, set_lr)``; ``set_lr(n)`` sets the rate of step n (from 0)."""
    opt = torch.optim.AdamW(
        vae.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
        fused=vae.device.type == "cuda",
    )
    f32 = np.float32

    def set_lr(step: int) -> None:
        frac = f32(min(step, total_steps)) / f32(total_steps)
        rate = f32(lr) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac, dtype=f32))
        for group in opt.param_groups:
            group["lr"] = float(rate)

    return opt, set_lr


def make_vae_train_step(
    vae: ConvVAE, opt: torch.optim.Optimizer, set_lr: Callable[[int], None], kl_weight: float
) -> Callable[..., Tensor]:
    """``step(x, generator=None, eps=None) -> mse``: loss, gradients and one
    AdamW update in place; the MSE comes back on the device, detached."""
    count = 0

    def step(x: Tensor, generator: Optional[torch.Generator] = None, *, eps=None) -> Tensor:
        nonlocal count
        opt.zero_grad(set_to_none=True)
        loss, mse = vae_loss(vae, x, kl_weight, generator, eps=eps)
        loss.backward()
        set_lr(count)
        opt.step()
        count += 1
        return mse.detach()

    return step


@torch.no_grad()
def calibrate_scaling_factor(vae: ConvVAE, images: np.ndarray, batch_size: int) -> float:
    """Set ``vae.scaling_factor`` to 1 / std of the encoder's mean output over
    the first min(n, 256) images, taken in whole batches only."""
    n = images.shape[0]
    s = s2 = cnt = 0.0
    for i in range(0, min(n, 256), batch_size):
        x = torch.as_tensor(images[i : i + batch_size], dtype=torch.float32, device=vae.device)
        if x.shape[0] < batch_size:
            continue
        mu = vae._encode_raw(x)[0]
        s += float(mu.sum())
        s2 += float((mu * mu).sum())
        cnt += mu.numel()
    var = max(s2 / cnt - (s / cnt) ** 2, 1e-12)
    vae.scaling_factor = float(1.0 / (var**0.5 + 1e-8))
    return vae.scaling_factor


def train_vae(
    vae: ConvVAE,
    images: np.ndarray,
    *,
    epochs: int = 40,
    batch_size: int = 32,
    lr: float = 2e-4,
    kl_weight: float = 1e-4,
    seed: int = 0,
    progress: bool = True,
) -> Tuple[Params, float]:
    """Train on an NHWC [-1, 1] corpus; returns (params, final recon MSE).

    The weights are drawn anew from ``seed`` and trained in place on the
    VAE's device; the returned tree is a copy for ``checkpoint.save_params``.
    After training, ``vae.scaling_factor`` is calibrated so that encoder
    outputs have about unit variance, and ``vae.save`` stores it in the
    checkpoint's config.
    """
    vae.reset_parameters(torch.Generator().manual_seed(seed))
    n = images.shape[0]
    batch_size = min(batch_size, n)  # tiny corpora: never skip every batch
    steps = max(n // batch_size, 1)
    opt, set_lr = make_vae_optimizer(vae, lr, epochs * steps)
    step = make_vae_train_step(vae, opt, set_lr, kl_weight)

    rng = np.random.default_rng(seed)
    mse = float("nan")
    for epoch in range(epochs):
        perm = rng.permutation(n)
        mses = []
        for i in range(steps):
            sl = perm[i * batch_size : (i + 1) * batch_size]
            if len(sl) < batch_size:
                continue
            gen = torch.Generator(device=vae.device).manual_seed(seed * 7919 + epoch * 1009 + i)
            x = torch.as_tensor(images[sl], dtype=torch.float32, device=vae.device)
            mses.append(step(x, gen))
        mse = float(torch.stack(mses).mean())  # one read per epoch
        if progress and (epoch + 1) % 5 == 0:
            print(f"[vae] epoch {epoch + 1}/{epochs} recon MSE {mse:.5f}", flush=True)

    calibrate_scaling_factor(vae, images, batch_size)
    return vae.params, mse


class LatentFlowPipeline:
    """Flow model in latent space + VAE decode: samples pixel images.

    Exposes the sampling surface the serving code expects (``sample``,
    ``image_size``, ``in_channels``) while the flow runs at latent
    resolution. The decode runs in ``decode_dtype`` (bf16 by default) on
    parameters rounded through it, and comes back in fp32; pass
    ``decode_dtype="float32"`` for a bit-faithful decode. ``vae_params``, when
    given, is a param tree loaded into ``vae`` first.
    """

    def __init__(
        self, flow_model, vae: ConvVAE, vae_params: Optional[Params] = None,
        decode_dtype: str = "bfloat16",
    ) -> None:
        if vae.device != flow_model.device:
            raise ValueError(f"the VAE is on {vae.device}, the flow model on {flow_model.device}")
        if vae_params is not None:
            vae.params = vae_params
        self.flow = flow_model
        self.vae = vae
        self.image_size = vae.image_size
        self.in_channels = vae.latent_channels
        self.decode_dtype = _DTYPES[decode_dtype]

    @torch.no_grad()
    def decode(self, z_nhwc: Tensor) -> Tensor:
        """Latents [B, h, w, latent] -> fp32 pixels clipped to [-1, 1] (the
        bf16 decoder can slightly overshoot the range)."""
        x = self.vae.decode(z_nhwc.float(), dtype=self.decode_dtype).float()
        return torch.clamp(x, -1.0, 1.0)

    @torch.no_grad()
    def sample(
        self,
        noise=None,
        num_steps: int = 4,
        batch_size: int = 4,
        data_format: str = "NCHW",
        cond=None,
        **kw,
    ) -> Tensor:
        """Latent noise -> latent flow sampling -> decoded pixels in [-1, 1].

        ``noise``, when given, is latent-shaped ([B, latent, h, w] for NCHW).
        ``cond``: a conditional flow model's rows by name, one per image.
        """
        z = self.flow.sample(
            noise=noise, num_steps=num_steps, batch_size=batch_size, data_format=data_format,
            cond=cond, **kw,
        )
        if data_format.upper() == "NCHW":
            z = z.permute(0, 2, 3, 1)
        return _from_nhwc(self.decode(z), data_format)

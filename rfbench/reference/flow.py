"""Flow matching around the reference networks: the Euler sampler that serves
images, and the train step (loss, gradient, global-norm clip, AdamW, EMA).

Rectified flow (Liu et al., arXiv:2209.03003): x_t = (1 - t) x0 + t x1 with
x0 noise, target velocity x1 - x0, loss the mean squared error of the
predicted velocity. Sampling integrates dx/dt = v(x, t) from noise at t = 0
with N Euler steps at t_i = i / N and clips to [-1, 1], after the decode on
the latent path. The train step clips the gradient to global norm 1, then
AdamW (0.9, 0.999, eps 1e-8, decoupled decay on every parameter) at a
per-epoch cosine rate, then the EMA e <- d e + (1 - d) p.

Random draws are replayed, not taken: the program documents that the service
draws one NHWC float32 normal batch per batch of a call from a
``torch.Generator`` seeded by the caller, and that a train step draws from
the generator it is given, in order, x0 (normal, the batch's shape), t
(uniform, one per row) and, for a UNet with dropout, one int32 seed per
residual block (``randint(2**31 - 1)``). A generator of the same device and
seed gives the same numbers here. Work is done in blocks of rows so that
float32 fits beside nothing else.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from rfbench.reference import unet, vae
from rfbench.reference.numerics import Numerics

Tensor = torch.Tensor


def skeleton(config: dict) -> Dict[str, torch.nn.Module]:
    """The reference modules of a configuration on the meta device:
    ``velocity_net`` (``NETWORK`` of ``reference/<backbone>.py``) and, on the
    latent path, ``vae``."""
    network = importlib.import_module(f"rfbench.reference.{config['model']['backbone']}").NETWORK
    with torch.device("meta"):
        mods = {"velocity_net": network(**config["model"])}
        if config.get("vae"):
            mods["vae"] = vae.ConvVAE(**config["vae"])
    return mods


def build(config: dict, weights: Dict[str, Dict[str, Tensor]], device) -> Dict[str, torch.nn.Module]:
    """The reference modules on ``device`` holding ``weights`` (by module,
    then parameter name), in float32."""
    mods = skeleton(config)
    for key, mod in mods.items():
        mod.to_empty(device=device)
        mod.load_state_dict({k: v.float() for k, v in weights[key].items()}, strict=True)
        mod.requires_grad_(False)
    return mods


@torch.no_grad()
def serve(mods, noise: Tensor, steps: int, num: Numerics, block: int) -> Tensor:
    """Served images (NHWC, clipped) for NHWC ``noise``, ``block`` rows at a time."""
    net, dec = mods["velocity_net"], mods.get("vae")
    out = []
    dt = float(np.float32(1.0 / steps))
    for x in noise.split(block):
        x = x.float()
        for i in range(steps):
            t = torch.full((x.shape[0],), float(np.float32(i) * np.float32(dt)), device=x.device)
            x = x + net.velocity(x, t, num) * dt
        if dec is not None:
            x = dec.decode(x, num).clamp(-1.0, 1.0)
        out.append(x.clamp(-1.0, 1.0))
    return torch.cat(out)


def epoch_cosine(lr: float, epochs: int, steps_per_epoch: int, step: int) -> float:
    f32 = np.float32
    frac = min(f32(step // max(steps_per_epoch, 1)) / f32(epochs), f32(1.0))
    return float(f32(0.5 * lr) * (f32(1.0) + np.cos(f32(np.pi) * frac, dtype=f32)))


def train(mods, corpus: Tensor, rows: List[Tensor], generator: torch.Generator, opt: dict,
          num: Numerics, block: int, use_rows: Optional[int] = None) -> dict:
    """Follow the train step over the batches ``corpus[rows[i]]``.

    ``opt``: lr, epochs, steps_per_epoch, weight_decay, ema_decay. Returns the
    step losses, the clipped gradient of step 1 (what the optimizer gets),
    and the parameters and EMA after the last step. ``use_rows`` takes the
    loss over the first rows of each batch only (a planted fault)."""
    net = mods["velocity_net"]
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    ema = {k: p.detach().clone() for k, p in params.items()}
    b1, b2, eps, wd, d = 0.9, 0.999, 1e-8, opt["weight_decay"], opt["ema_decay"]
    losses, first_grad = [], None
    dropout = isinstance(net, unet.UNet) and net.rate > 0
    for step, idx in enumerate(rows, start=1):
        x1 = corpus.index_select(0, idx).float()
        bsz = x1.shape[0]
        x0 = torch.randn(x1.shape, generator=generator, dtype=torch.float32, device=x1.device)
        t = torch.rand((bsz,), generator=generator, dtype=torch.float32, device=x1.device)
        seeds = None
        if dropout:
            seeds = torch.randint(2**31 - 1, (net.num_dropout_seeds,), generator=generator,
                                  dtype=torch.int32, device=x1.device)
        n_rows = use_rows or bsz
        total = float(n_rows * x1[0].numel())
        loss = 0.0
        for p in params.values():
            p.grad = None
        for r0 in range(0, n_rows, block):
            r1 = min(r0 + block, n_rows)
            tb = t[r0:r1].reshape(-1, 1, 1, 1)
            xt = (1.0 - tb) * x0[r0:r1] + tb * x1[r0:r1]
            pred = net.velocity(xt, t[r0:r1], num, seeds, image0=r0)
            part = torch.sum(torch.square(pred - (x1[r0:r1] - x0[r0:r1]))) / total
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in params.values()]))
        clip = torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
        grads = {k: p.grad * clip for k, p in params.items()}
        if first_grad is None:
            first_grad = grads
        lr = epoch_cosine(opt["lr"], opt["epochs"], opt["steps_per_epoch"], step - 1)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                p.mul_(1.0 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v[k].sqrt() / math.sqrt(1 - b2**step) + eps
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1**step))
                ema[k].mul_(d).add_(p, alpha=1 - d)
    net.requires_grad_(False)
    return {"losses": losses, "grad": first_grad,
            "params": {k: p.detach().clone() for k, p in params.items()}, "ema": ema}

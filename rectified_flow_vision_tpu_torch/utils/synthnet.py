"""SynthNet: the trained stand-in feature backbone for FID and LPIPS.

Counterpart of the inference half of the JAX package's ``utils/synthnet.py``,
on the same committed weights (``weights/synthnet.npz``): four stages of
(3x3 conv, GroupNorm(8), ReLU) x 2 with 32, 64, 128 and 256 channels, each
followed by a 2x2 average pool, and three dense heads (shape counts, blur
level, noise level) on the pooled last stage.

* FID features: every stage's globally pooled activations, concatenated
  (32 + 64 + 128 + 256 = 480-d);
* perceptual distance: LPIPS's recipe with uniform layer weights (each
  stage's taps unit-normalised over channels, squared difference, mean over
  positions and channels, summed over the stages).

The convs and GroupNorms are XLA ops in the JAX package, outside any Pallas
kernel, so here they are ``F.conv2d`` / ``F.group_norm`` on the module's
device, in exact fp32 (``ops.primitives.exact_fp32``).

Training (``train_synthnet``): the JAX recipe on the same procedural corpora
(``make_labeled_corpus``, ``make_corrupted_corpus``: numpy, identical bits
for a seed) and the same batch order; shape-count, blur-level and
noise-level cross-entropies summed; AdamW (weight decay 1e-4) on a cosine
decay of the lr over every step. ``jax.random`` cannot be replayed, so an
initial tree from the JAX package's ``init_params`` can be handed in
(``params=``); without one the port draws its own.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rectified_flow_vision_tpu_torch.config import WEIGHTS_DIR
from rectified_flow_vision_tpu_torch.ops.primitives import exact_fp32

DEFAULT_WEIGHTS_PATH = WEIGHTS_DIR / "synthnet.npz"

STAGE_CHANNELS = (32, 64, 128, 256)
NUM_TYPES = 3  # circle, rectangle, gradient
MAX_COUNT = 7  # 0..7 shapes of a type per image
NUM_GROUPS = 8

# Corruption-level label spaces of the auxiliary heads: blur sigmas in
# pixels, noise sigmas in [-1, 1] pixel units; level 0 is the clean image.
NUM_LEVELS = 8
BLUR_SIGMAS = tuple(0.35 * i for i in range(NUM_LEVELS))  # 0 .. 2.45 px
NOISE_SIGMAS = tuple(0.05 * i for i in range(NUM_LEVELS))  # 0 .. 0.35

Params = Dict[str, Dict[str, torch.Tensor]]


def init_params(generator: torch.Generator, in_channels: int = 3,
                device: str | torch.device = "cuda") -> Params:
    """A fresh SynthNet tree with torch's default init (weights and biases
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), GroupNorm scale 1 and bias 0), the
    shapes of the JAX package's ``init_params``."""

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    def conv(cin, cout):
        return {"w": uniform((3, 3, cin, cout), 9 * cin), "b": uniform((cout,), 9 * cin)}

    def dense(cin, cout):
        return {"w": uniform((cin, cout), cin), "b": uniform((cout,), cin)}

    def norm(ch):
        return {"scale": torch.ones(ch), "bias": torch.zeros(ch)}

    params: Params = {}
    cin = in_channels
    for s, ch in enumerate(STAGE_CHANNELS):
        params[f"s{s}_conv0"], params[f"s{s}_gn0"] = conv(cin, ch), norm(ch)
        params[f"s{s}_conv1"], params[f"s{s}_gn1"] = conv(ch, ch), norm(ch)
        cin = ch
    params["head"] = dense(STAGE_CHANNELS[-1], NUM_TYPES * (MAX_COUNT + 1))
    params["blur_head"] = dense(STAGE_CHANNELS[-1], NUM_LEVELS)
    params["noise_head"] = dense(STAGE_CHANNELS[-1], NUM_LEVELS)
    return {k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()}


def load_weights(path=DEFAULT_WEIGHTS_PATH, device: str | torch.device = "cuda") -> Params:
    """The ``{layer: {name: tensor}}`` tree of a SynthNet ``.npz`` (HWIO convs,
    (in, out) dense layers), as fp32 tensors on ``device``."""
    params: Params = {}
    with np.load(path) as data:
        for key in data.files:
            k, name = key.split("/")
            params.setdefault(k, {})[name] = torch.as_tensor(
                np.asarray(data[key], np.float32), device=device
            )
    return params


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _conv_gn_relu(h: torch.Tensor, conv, gn) -> torch.Tensor:
    h = F.conv2d(h, conv["w"].permute(3, 2, 0, 1), conv["b"], padding=1)
    return F.relu(F.group_norm(h, NUM_GROUPS, gn["scale"], gn["bias"], eps=1e-5))


def _taps_nchw(params: Params, x_nchw: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Per-stage activations (NCHW) and the pooled last stage [B, 256], in
    exact fp32 (TF32 off, so that a card computes what the CPU does up to
    summation order)."""
    h = x_nchw.float()
    taps = []
    with exact_fp32():
        for s in range(len(STAGE_CHANNELS)):
            h = _conv_gn_relu(h, params[f"s{s}_conv0"], params[f"s{s}_gn0"])
            h = _conv_gn_relu(h, params[f"s{s}_conv1"], params[f"s{s}_gn1"])
            taps.append(h)
            h = F.avg_pool2d(h, 2)
    return taps, h.mean(dim=(2, 3))


def apply_full(params: Params, x: torch.Tensor) -> dict:
    """Forward pass with every head on [B, H, W, C] images in [-1, 1]
    (differentiable in ``params``, as the JAX function is).

    Returns ``counts`` [B, NUM_TYPES, MAX_COUNT+1], ``blur`` / ``noise``
    [B, NUM_LEVELS] level logits (zeros for weights without the auxiliary
    heads) and ``taps``, the per-stage activations in NHWC.
    """
    taps, pooled = _taps_nchw(params, x.permute(0, 3, 1, 2))
    zeros = torch.zeros((x.shape[0], NUM_LEVELS), dtype=torch.float32, device=x.device)
    return {
        "counts": _dense(pooled, params["head"]).reshape(-1, NUM_TYPES, MAX_COUNT + 1),
        "blur": _dense(pooled, params["blur_head"]) if "blur_head" in params else zeros,
        "noise": _dense(pooled, params["noise_head"]) if "noise_head" in params else zeros,
        "taps": [t.permute(0, 2, 3, 1) for t in taps],
    }


def apply(params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(counts logits, NHWC stage taps); see ``apply_full``."""
    out = apply_full(params, x)
    return out["counts"], out["taps"]


def synthesize_labeled_image(rng: np.random.Generator, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """One procedural image and its per-type shape counts: the recipe of
    ``download_data.synthesize_image``, recording which painter ran."""
    from rectified_flow_vision_tpu_torch.utils.download_data import _PAINTERS

    img = np.empty((size, size, 3), dtype=np.uint8)
    img[:, :] = rng.integers(0, 256, 3)
    counts = np.zeros(NUM_TYPES, np.int32)
    for _ in range(int(rng.integers(3, 8))):
        t = int(rng.integers(0, NUM_TYPES))
        _PAINTERS[t](img, rng, size)
        counts[t] += 1
    return img, counts


def make_labeled_corpus(n: int, size: int = 64, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """[N, H, W, C] float32 images in [-1, 1] + [N, NUM_TYPES] count labels."""
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, size, size, 3), np.float32)
    labels = np.empty((n, NUM_TYPES), np.int32)
    for i in range(n):
        img, cnt = synthesize_labeled_image(rng, size)
        imgs[i] = img.astype(np.float32) / 255.0 * 2.0 - 1.0
        labels[i] = cnt
    return imgs, labels


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian blur of one [H, W, C] image (separable, reflect padding)."""
    if sigma <= 0:
        return img
    from scipy.ndimage import gaussian_filter1d

    out = gaussian_filter1d(img, sigma, axis=0, mode="reflect")
    return gaussian_filter1d(out, sigma, axis=1, mode="reflect")


def corrupt_image(img: np.ndarray, rng: np.random.Generator) -> Tuple[np.ndarray, int, int]:
    """Blur, then noise, one [H, W, C] image in [-1, 1] at random levels.

    Returns (corrupted image, blur level, noise level); the levels index
    ``BLUR_SIGMAS`` / ``NOISE_SIGMAS``, both 0 for a clean image.
    """
    blur_lvl = int(rng.integers(0, NUM_LEVELS))
    noise_lvl = int(rng.integers(0, NUM_LEVELS))
    out = gaussian_blur(img, BLUR_SIGMAS[blur_lvl])
    if noise_lvl:
        out = out + rng.normal(0.0, NOISE_SIGMAS[noise_lvl], out.shape)
    return np.clip(out, -1.0, 1.0).astype(np.float32), blur_lvl, noise_lvl


def make_corrupted_corpus(
    n: int, size: int = 64, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(images [N, H, W, C] in [-1, 1], counts [N, NUM_TYPES], blur levels
    [N], noise levels [N]): the labeled corpus, each image corrupted."""
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, size, size, 3), np.float32)
    counts = np.empty((n, NUM_TYPES), np.int32)
    blur = np.empty((n,), np.int32)
    noise = np.empty((n,), np.int32)
    for i in range(n):
        img, cnt = synthesize_labeled_image(rng, size)
        x = img.astype(np.float32) / 255.0 * 2.0 - 1.0
        imgs[i], blur[i], noise[i] = corrupt_image(x, rng)
        counts[i] = cnt
    return imgs, counts, blur, noise


def _losses_and_metrics(params: Params, xb, cb, bb, nb):
    """(summed cross-entropies, accuracies) of one labeled batch."""
    out = apply_full(params, xb)
    counts = out["counts"].reshape(-1, MAX_COUNT + 1)
    loss = (F.cross_entropy(counts, cb.reshape(-1)) + F.cross_entropy(out["blur"], bb)
            + F.cross_entropy(out["noise"], nb))
    acc = {
        "count_acc": (out["counts"].argmax(-1) == cb).float().mean(),
        "blur_acc": (out["blur"].argmax(-1) == bb).float().mean(),
        "noise_acc": (out["noise"].argmax(-1) == nb).float().mean(),
    }
    return loss, acc


def train_synthnet(
    n_train: int = 6144,
    n_val: int = 512,
    size: int = 64,
    batch: int = 128,
    epochs: int = 20,
    lr: float = 3e-4,
    seed: int = 0,
    progress: bool = True,
    *,
    params: Optional[Dict] = None,
    device: str | torch.device = "cuda",
) -> Tuple[Params, Dict[str, float]]:
    """Train SynthNet on corrupted labeled data; the JAX package's
    ``train_synthnet``.

    Joint objective: shape-count CE + blur-level CE + noise-level CE, all
    heads on the pooled stage-4 features. A size mix (2/3 of the batches at
    ``size``, 1/3 at ``size // 2``, shuffled per epoch by the JAX schedule's
    numpy stream) calibrates the fully convolutional backbone at both
    evaluation resolutions. AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay
    1e-4 on every leaf) at ``lr`` on a cosine decay to 0 over every step,
    as ``optax.adamw(optax.cosine_decay_schedule(lr, total), weight_decay=1e-4)``.

    ``params``: the initial tree ({layer: {name: array or tensor}}, on any
    device, HWIO convs; e.g.
    the JAX package's ``init_params``), else the port's ``init_params`` from
    ``seed``. Runs on ``device`` (the card unless the caller asks for the
    CPU). Returns (params, validation count / blur / noise accuracies).
    """
    from rectified_flow_vision_tpu_torch.models.base_flow import resolve_device

    device = resolve_device(device)
    n64 = (n_train * 2 // 3 // batch) * batch
    n32 = (n_train // 3 // batch) * batch
    data = {
        size: make_corrupted_corpus(n64, size, seed=seed),
        size // 2: make_corrupted_corpus(n32, size // 2, seed=seed + 7),
    }
    va = make_corrupted_corpus(n_val, size, seed=seed + 1)

    if params is None:
        params = init_params(torch.Generator().manual_seed(seed), device=device)

    def leaf(v) -> torch.Tensor:  # numpy, or a tensor on any device
        v = v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v, np.float32))
        return v.detach().to(device, torch.float32, copy=True).requires_grad_(True)

    params = {k: {n: leaf(v) for n, v in sub.items()} for k, sub in params.items()}
    leaves = [t for sub in params.values() for t in sub.values()]
    total = epochs * ((n64 + n32) // batch)

    def schedule(step: int) -> float:  # optax.cosine_decay_schedule(lr, total)
        return lr * 0.5 * (1.0 + math.cos(math.pi * min(step, total) / total))

    opt = torch.optim.AdamW(leaves, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)

    def on_device(x, c, b, nz):
        return (torch.as_tensor(x, device=device),
                *(torch.as_tensor(a, dtype=torch.long, device=device) for a in (c, b, nz)))

    def val_metrics() -> Dict[str, float]:
        with torch.no_grad():
            return {k: float(v) for k, v in _losses_and_metrics(params, *on_device(*va))[1].items()}

    rng = np.random.default_rng(seed)
    step = 0
    for epoch in range(epochs):
        # interleave the two resolutions, in the JAX schedule's order
        sched_sizes = [size] * (n64 // batch) + [size // 2] * (n32 // batch)
        rng.shuffle(sched_sizes)
        cursors = {s: rng.permutation(len(data[s][0])) for s in data}
        offs = {s: 0 for s in data}
        losses = []
        for s in sched_sizes:
            x, c, b, nz = data[s]
            sl = cursors[s][offs[s] : offs[s] + batch]
            offs[s] += batch
            batch_dev = on_device(x[sl], c[sl], b[sl], nz[sl])
            with exact_fp32():  # the backward's convs too
                loss, _ = _losses_and_metrics(params, *batch_dev)
                opt.zero_grad(set_to_none=True)
                loss.backward()
            for group in opt.param_groups:
                group["lr"] = schedule(step)
            opt.step()
            step += 1
            losses.append(loss.detach())
        if progress:
            m = val_metrics()
            print(
                f"[synthnet] epoch {epoch + 1}/{epochs} "
                f"loss {float(torch.stack(losses).mean()):.4f} "
                f"val count {m['count_acc']:.3f} blur {m['blur_acc']:.3f} "
                f"noise {m['noise_acc']:.3f}",
                flush=True,
            )
    trained = {k: {n: t.detach() for n, t in sub.items()} for k, sub in params.items()}
    return trained, val_metrics()


def save_weights(params: Params, path=DEFAULT_WEIGHTS_PATH) -> None:
    """Write a SynthNet tree as the ``.npz`` that ``load_weights`` (and the JAX
    package's) reads: ``<layer>/<name>`` keys, HWIO convs."""
    flat = {}
    for k, sub in params.items():
        for name, arr in sub.items():
            flat[f"{k}/{name}"] = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
                                   else np.asarray(arr))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def _unit_channels(a: torch.Tensor) -> torch.Tensor:
    return a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)


class SynthNetPerceptual:
    """The metric adapter: callable perceptual distance, ``fid_features`` and
    ``pairwise_distance`` on [B, C, H, W] numpy batches in [-1, 1], computed
    on ``device`` and returned as numpy."""

    backbone_name = "synthnet"

    def __init__(self, params: Params, device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self.params = {k: {n: t.to(self.device) for n, t in v.items()} for k, v in params.items()}

    @classmethod
    def load_default(cls, device: str | torch.device = "cuda") -> "SynthNetPerceptual":
        if not DEFAULT_WEIGHTS_PATH.exists():
            raise FileNotFoundError(f"SynthNet weights not found at {DEFAULT_WEIGHTS_PATH}")
        return cls(load_weights(DEFAULT_WEIGHTS_PATH, device), device)

    def _taps(self, images) -> List[torch.Tensor]:
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        return _taps_nchw(self.params, x)[0]

    @torch.no_grad()
    def __call__(self, img1, img2) -> np.ndarray:
        """Perceptual distances of row-paired [B, C, H, W] batches."""
        total = 0.0
        for a, b in zip(self._taps(img1), self._taps(img2)):
            total = total + torch.mean((_unit_channels(a) - _unit_channels(b)) ** 2, dim=(1, 2, 3))
        return total.cpu().numpy()

    @torch.no_grad()
    def fid_features(self, images) -> np.ndarray:
        """Multi-stage pooled features [B, 480] of [B, C, H, W] images."""
        return torch.cat([t.mean(dim=(2, 3)) for t in self._taps(images)], dim=-1).cpu().numpy()

    def _norm_flat_taps(self, images) -> List[torch.Tensor]:
        """Per-stage channel-unit-normalised taps, flattened to [B, C*H*W]
        and scaled so that dot(u_i, v_j) is the stage's cross term
        mean_{h,w,c}(na . nb)."""
        flats = []
        for a in self._taps(images):
            na = _unit_channels(a)
            chw = na.shape[1] * na.shape[2] * na.shape[3]
            flats.append(na.reshape(na.shape[0], chw) / np.sqrt(chw))
        return flats

    @torch.no_grad()
    def pairwise_distance(self, imgs_a, imgs_b) -> np.ndarray:
        """All-pairs perceptual distances [B_a, B_b]: per stage
        |u_i|^2 + |v_j|^2 - 2 u_i.v_j, the paired distance of every (i, j)."""
        total = None
        for u, v in zip(self._norm_flat_taps(imgs_a), self._norm_flat_taps(imgs_b)):
            d = (u * u).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2.0 * (u @ v.T)
            total = d if total is None else total + d
        return torch.clamp(total, min=0.0).cpu().numpy()

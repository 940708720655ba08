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
device. Training the backbone (``train_synthnet`` and its corpora) is not
ported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rectified_flow_vision_tpu_torch.config import WEIGHTS_DIR

DEFAULT_WEIGHTS_PATH = WEIGHTS_DIR / "synthnet.npz"

STAGE_CHANNELS = (32, 64, 128, 256)
NUM_TYPES = 3  # circle, rectangle, gradient
MAX_COUNT = 7  # 0..7 shapes of a type per image
NUM_LEVELS = 8  # blur / noise levels of the auxiliary heads
NUM_GROUPS = 8

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
    fp32 (cuDNN's TF32 convs off, so that a card computes what the CPU does
    up to summation order)."""
    cudnn = torch.backends.cudnn
    h = x_nchw.float()
    taps = []
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        for s in range(len(STAGE_CHANNELS)):
            h = _conv_gn_relu(h, params[f"s{s}_conv0"], params[f"s{s}_gn0"])
            h = _conv_gn_relu(h, params[f"s{s}_conv1"], params[f"s{s}_gn1"])
            taps.append(h)
            h = F.avg_pool2d(h, 2)
    return taps, h.mean(dim=(2, 3))


@torch.no_grad()
def apply_full(params: Params, x: torch.Tensor) -> dict:
    """Forward pass with every head on [B, H, W, C] images in [-1, 1].

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

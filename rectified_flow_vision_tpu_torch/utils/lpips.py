"""LPIPS perceptual distance (AlexNet backbone) in PyTorch.

Counterpart of the JAX package's ``utils/lpips_jax.py``: AlexNet's
``features`` trunk (relu1..relu5 taps) -> per-layer channel-unit
normalisation (eps 1e-10) -> squared difference -> learned 1x1 linear heads
(clamped at 0) -> spatial mean -> sum over layers. Input is [B, C, H, W] in
[-1, 1], scaled by the LPIPS shift / scale constants. It loads the same
``.npz`` (``conv{i}_w`` HWIO, ``conv{i}_b``, ``lin{i}_w``), which
``tools/convert_lpips_weights.py`` makes on a machine with the ``lpips`` pip
package.

``LPIPS.load_default`` raises ``FileNotFoundError`` while
``weights/lpips_alex.npz`` is not in the repo, so ``MetricsCalculator``
takes the SynthNet stand-in, as the JAX package does.

The convs and pools are ``F.conv2d`` / ``F.max_pool2d`` (the JAX package
computes them with ``lax`` ops outside any Pallas kernel), in exact fp32
(``ops.primitives.exact_fp32``): cuDNN's TF32 default would change the
metric on the card.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from rectified_flow_vision_tpu_torch.config import WEIGHTS_DIR
from rectified_flow_vision_tpu_torch.ops.primitives import exact_fp32

DEFAULT_WEIGHTS_PATH = WEIGHTS_DIR / "lpips_alex.npz"

# LPIPS input scaling constants (per channel, RGB).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet features trunk: (kernel, stride, pad, out_ch, maxpool_after)
_ALEX_LAYERS = [
    (11, 4, 2, 64, True),
    (5, 1, 2, 192, True),
    (3, 1, 1, 384, False),
    (3, 1, 1, 256, False),
    (3, 1, 1, 256, False),
]


def _on_device(images, device: torch.device) -> torch.Tensor:
    """A numpy batch or a tensor as an fp32 tensor on ``device``."""
    if isinstance(images, torch.Tensor):
        return images.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(images, np.float32), device=device)


def _unit_channels(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Each position's channel vector over its norm + eps (NCHW)."""
    return feat / (torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True)) + eps)


class LPIPS:
    """LPIPS evaluator on ``device``. ``weights`` maps conv{i}_{w,b} and
    lin{i}_w arrays; inputs are [B, C, H, W] batches in [-1, 1] (numpy or
    tensors), outputs numpy (``distance``: a tensor on the device)."""

    backbone_name = "alexnet"

    def __init__(self, weights: Dict[str, np.ndarray], device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        w = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
             for k, v in weights.items()}
        # HWIO -> OIHW once
        self.convs = [(w[f"conv{i}_w"].permute(3, 2, 0, 1).contiguous(), w[f"conv{i}_b"])
                      for i in range(len(_ALEX_LAYERS))]
        self.lins = [torch.clamp(w[f"lin{i}_w"], min=0.0) for i in range(len(_ALEX_LAYERS))]
        self._shift = torch.tensor(_SHIFT, device=self.device).reshape(1, 3, 1, 1)
        self._scale = torch.tensor(_SCALE, device=self.device).reshape(1, 3, 1, 1)

    @classmethod
    def load_default(cls, device: str | torch.device = "cuda") -> "LPIPS":
        if not DEFAULT_WEIGHTS_PATH.exists():
            raise FileNotFoundError(
                f"LPIPS weights not found at {DEFAULT_WEIGHTS_PATH}; run "
                "tools/convert_lpips_weights.py on a machine with the lpips pip package."
            )
        with np.load(DEFAULT_WEIGHTS_PATH) as data:
            return cls({k: data[k] for k in data.files}, device)

    def _taps(self, images) -> List[torch.Tensor]:
        """relu1..relu5 activations (NCHW) of LPIPS-scaled images."""
        h = (_on_device(images, self.device) - self._shift) / self._scale
        taps = []
        with exact_fp32():
            for (w, b), (_, stride, pad, _, pool) in zip(self.convs, _ALEX_LAYERS):
                h = F.relu(F.conv2d(h, w, b, stride=stride, padding=pad))
                taps.append(h)
                if pool:
                    h = F.max_pool2d(h, 3, 2)
        return taps

    @torch.no_grad()
    def distance(self, img1, img2) -> torch.Tensor:
        """LPIPS distances [B] of row-paired [B, C, H, W] batches in [-1, 1],
        on the device."""
        total = 0.0
        for a, b, lin in zip(self._taps(img1), self._taps(img2), self.lins):
            d = (_unit_channels(a) - _unit_channels(b)) ** 2  # [B, C, H, W]
            val = torch.sum(d * lin.reshape(1, -1, 1, 1), dim=1)  # [B, H, W]
            total = total + torch.mean(val, dim=(1, 2))
        return total

    def __call__(self, img1, img2) -> np.ndarray:
        """LPIPS distances [B] of row-paired [B, C, H, W] batches in [-1, 1]."""
        return self.distance(img1, img2).cpu().numpy()

    @torch.no_grad()
    def fid_features(self, images) -> np.ndarray:
        """Spatially pooled relu5 activations [B, 256] of [B, C, H, W]
        images in [-1, 1]: the deep features of the learned-feature FID."""
        return self._taps(images)[-1].mean(dim=(2, 3)).cpu().numpy()

    def _norm_flat_taps(self, images) -> List[torch.Tensor]:
        """Per-stage normalised taps weighted by the learned lin heads,
        flattened so that dot products give the LPIPS cross terms."""
        flats = []
        for a, lin in zip(self._taps(images), self.lins):
            scaled = _unit_channels(a) * torch.sqrt(lin).reshape(1, -1, 1, 1)
            hw = a.shape[2] * a.shape[3]
            flats.append(scaled.permute(0, 2, 3, 1).reshape(a.shape[0], -1) / np.sqrt(hw))
        return flats

    @torch.no_grad()
    def pairwise_distance(self, imgs_a, imgs_b) -> np.ndarray:
        """All-pairs LPIPS distances [B_a, B_b] by the Gram-matrix identity
        (exact: three matmuls per stage instead of B_a * B_b forwards)."""
        total = None
        with exact_fp32():
            for u, v in zip(self._norm_flat_taps(imgs_a), self._norm_flat_taps(imgs_b)):
                d = (u * u).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2.0 * (u @ v.T)
                total = d if total is None else total + d
        return torch.clamp(total, min=0.0).cpu().numpy()

"""InceptionV3 pool3 features for FID, in PyTorch.

Counterpart of the JAX package's ``utils/inception_jax.py``: torchvision's
InceptionV3 feature trunk through the global average pool (2048-d pool3
features), BatchNorm folded into a per-channel scale / shift at conversion
time (``_bconv``: conv without bias, scale, shift, ReLU). The layer
inventory is declared once in ``CONV_SPECS`` (name -> in, out, kernel,
stride, pad), as in the JAX module; the forward graph and
``synthetic_weights`` share it. It loads the same ``.npz`` (``<name>.w``
HWIO, ``<name>.scale``, ``<name>.shift``), which
``tools/convert_inception_weights.py`` makes with torchvision.

``InceptionV3Features.load_default`` raises ``FileNotFoundError`` while
``weights/inception_v3.npz`` is not in the repo, so ``MetricsCalculator``
takes the SynthNet stand-in, as the JAX package does.

Where the two frameworks differ by default:

* the input is resized to 299x299 as ``jax.image.resize(..., "bilinear")``
  does it: half-pixel centres, and antialiased (a triangle kernel widened
  by the scale) when it shrinks: ``F.interpolate(mode="bilinear",
  align_corners=False, antialias=True)``;
* ``_avgpool3`` divides by 9 at the zero-padded borders too
  (``count_include_pad=True``), ``_maxpool`` pads with -inf (``F.max_pool2d``
  does);
* the convs run in exact fp32 (``ops.primitives.exact_fp32``): cuDNN's TF32
  default would change the metric on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rectified_flow_vision_tpu_torch.config import WEIGHTS_DIR
from rectified_flow_vision_tpu_torch.ops.primitives import exact_fp32
from rectified_flow_vision_tpu_torch.utils.lpips import _on_device

DEFAULT_WEIGHTS_PATH = WEIGHTS_DIR / "inception_v3.npz"

# name: (in_ch, out_ch, (kh, kw), stride, (ph, pw))
CONV_SPECS: Dict[str, Tuple[int, int, Tuple[int, int], int, Tuple[int, int]]] = {}


def _spec(name, cin, cout, k, s=1, p=(0, 0)):
    CONV_SPECS[name] = (cin, cout, k, s, p)


# ---- stem -----------------------------------------------------------------
_spec("Conv2d_1a_3x3", 3, 32, (3, 3), 2)
_spec("Conv2d_2a_3x3", 32, 32, (3, 3))
_spec("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1))
_spec("Conv2d_3b_1x1", 64, 80, (1, 1))
_spec("Conv2d_4a_3x3", 80, 192, (3, 3))


def _inception_a(prefix, cin, pool_features):
    _spec(f"{prefix}.branch1x1", cin, 64, (1, 1))
    _spec(f"{prefix}.branch5x5_1", cin, 48, (1, 1))
    _spec(f"{prefix}.branch5x5_2", 48, 64, (5, 5), 1, (2, 2))
    _spec(f"{prefix}.branch3x3dbl_1", cin, 64, (1, 1))
    _spec(f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1))
    _spec(f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1))
    _spec(f"{prefix}.branch_pool", cin, pool_features, (1, 1))
    return 64 + 64 + 96 + pool_features


def _inception_b(prefix, cin):
    _spec(f"{prefix}.branch3x3", cin, 384, (3, 3), 2)
    _spec(f"{prefix}.branch3x3dbl_1", cin, 64, (1, 1))
    _spec(f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1))
    _spec(f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), 2)
    return 384 + 96 + cin


def _inception_c(prefix, cin, c7):
    _spec(f"{prefix}.branch1x1", cin, 192, (1, 1))
    _spec(f"{prefix}.branch7x7_1", cin, c7, (1, 1))
    _spec(f"{prefix}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3))
    _spec(f"{prefix}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0))
    _spec(f"{prefix}.branch7x7dbl_1", cin, c7, (1, 1))
    _spec(f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0))
    _spec(f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3))
    _spec(f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0))
    _spec(f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3))
    _spec(f"{prefix}.branch_pool", cin, 192, (1, 1))
    return 192 * 4


def _inception_d(prefix, cin):
    _spec(f"{prefix}.branch3x3_1", cin, 192, (1, 1))
    _spec(f"{prefix}.branch3x3_2", 192, 320, (3, 3), 2)
    _spec(f"{prefix}.branch7x7x3_1", cin, 192, (1, 1))
    _spec(f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3))
    _spec(f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0))
    _spec(f"{prefix}.branch7x7x3_4", 192, 192, (3, 3), 2)
    return 320 + 192 + cin


def _inception_e(prefix, cin):
    _spec(f"{prefix}.branch1x1", cin, 320, (1, 1))
    _spec(f"{prefix}.branch3x3_1", cin, 384, (1, 1))
    _spec(f"{prefix}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1))
    _spec(f"{prefix}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0))
    _spec(f"{prefix}.branch3x3dbl_1", cin, 448, (1, 1))
    _spec(f"{prefix}.branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1))
    _spec(f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1))
    _spec(f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0))
    _spec(f"{prefix}.branch_pool", cin, 192, (1, 1))
    return 320 + 768 + 768 + 192


_c = _inception_a("Mixed_5b", 192, 32)
_c = _inception_a("Mixed_5c", _c, 64)
_c = _inception_a("Mixed_5d", _c, 64)
_c = _inception_b("Mixed_6a", _c)
_c = _inception_c("Mixed_6b", _c, 128)
_c = _inception_c("Mixed_6c", _c, 160)
_c = _inception_c("Mixed_6d", _c, 160)
_c = _inception_c("Mixed_6e", _c, 192)
_c = _inception_d("Mixed_7a", _c)
_c = _inception_e("Mixed_7b", _c)
FEATURE_DIM_IN = _inception_e("Mixed_7c", _c)  # 2048


# ---------------------------------------------------------------------------
# forward (NCHW; weights OIHW)
# ---------------------------------------------------------------------------

Weights = Dict[str, torch.Tensor]


def _bconv(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    """BasicConv2d: conv (no bias) + folded-BN scale/shift + relu."""
    _, _, _, stride, pad = CONV_SPECS[name]
    out = F.conv2d(x, w[f"{name}.w"], stride=stride, padding=pad)
    return F.relu(out * w[f"{name}.scale"] + w[f"{name}.shift"])


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    # torch's default count_include_pad=True: always /9, as the JAX module
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat(xs, dim=1)


def _block_a(w, p, x):
    b1 = _bconv(w, f"{p}.branch1x1", x)
    b5 = _bconv(w, f"{p}.branch5x5_2", _bconv(w, f"{p}.branch5x5_1", x))
    b3 = _bconv(
        w, f"{p}.branch3x3dbl_3",
        _bconv(w, f"{p}.branch3x3dbl_2", _bconv(w, f"{p}.branch3x3dbl_1", x)),
    )
    bp = _bconv(w, f"{p}.branch_pool", _avgpool3(x))
    return _cat(b1, b5, b3, bp)


def _block_b(w, p, x):
    b3 = _bconv(w, f"{p}.branch3x3", x)
    bd = _bconv(
        w, f"{p}.branch3x3dbl_3",
        _bconv(w, f"{p}.branch3x3dbl_2", _bconv(w, f"{p}.branch3x3dbl_1", x)),
    )
    return _cat(b3, bd, _maxpool(x))


def _block_c(w, p, x):
    b1 = _bconv(w, f"{p}.branch1x1", x)
    b7 = _bconv(
        w, f"{p}.branch7x7_3",
        _bconv(w, f"{p}.branch7x7_2", _bconv(w, f"{p}.branch7x7_1", x)),
    )
    bd = x
    for i in range(1, 6):
        bd = _bconv(w, f"{p}.branch7x7dbl_{i}", bd)
    bp = _bconv(w, f"{p}.branch_pool", _avgpool3(x))
    return _cat(b1, b7, bd, bp)


def _block_d(w, p, x):
    b3 = _bconv(w, f"{p}.branch3x3_2", _bconv(w, f"{p}.branch3x3_1", x))
    b7 = x
    for i in range(1, 5):
        b7 = _bconv(w, f"{p}.branch7x7x3_{i}", b7)
    return _cat(b3, b7, _maxpool(x))


def _block_e(w, p, x):
    b1 = _bconv(w, f"{p}.branch1x1", x)
    b3 = _bconv(w, f"{p}.branch3x3_1", x)
    b3 = _cat(_bconv(w, f"{p}.branch3x3_2a", b3), _bconv(w, f"{p}.branch3x3_2b", b3))
    bd = _bconv(w, f"{p}.branch3x3dbl_2", _bconv(w, f"{p}.branch3x3dbl_1", x))
    bd = _cat(_bconv(w, f"{p}.branch3x3dbl_3a", bd), _bconv(w, f"{p}.branch3x3dbl_3b", bd))
    bp = _bconv(w, f"{p}.branch_pool", _avgpool3(x))
    return _cat(b1, b3, bd, bp)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW images to 299x299 as ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, antialiased when shrinking."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=True)


class InceptionV3Features:
    """pool3 (2048-d) features for FID on ``device``. Input: [B, C, H, W] in
    [-1, 1] (numpy or tensor); output numpy [B, 2048]."""

    def __init__(self, weights: Dict[str, np.ndarray], device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        w = {}
        for k, v in weights.items():
            t = torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            if k.endswith(".w"):
                t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            else:  # per-channel scale / shift, broadcast over NCHW
                t = t.reshape(1, -1, 1, 1)
            w[k] = t
        self.w = w

    @classmethod
    def load_default(cls, device: str | torch.device = "cuda") -> "InceptionV3Features":
        if not DEFAULT_WEIGHTS_PATH.exists():
            raise FileNotFoundError(
                f"InceptionV3 weights not found at {DEFAULT_WEIGHTS_PATH}; "
                "run tools/convert_inception_weights.py with torchvision."
            )
        with np.load(DEFAULT_WEIGHTS_PATH) as data:
            return cls({k: data[k] for k in data.files}, device)

    @torch.no_grad()
    def forward(self, images) -> torch.Tensor:
        """pool3 features [B, 2048] on the device."""
        x = _on_device(images, self.device)
        # torchvision's pretrained trunk takes [-1, 1] directly (its
        # transform_input maps an ImageNet-normalised input to [-1, 1]): no
        # transform here, as in the JAX module
        w = self.w
        with exact_fp32():
            x = resize_299(x)
            x = _bconv(w, "Conv2d_1a_3x3", x)
            x = _bconv(w, "Conv2d_2a_3x3", x)
            x = _bconv(w, "Conv2d_2b_3x3", x)
            x = _maxpool(x)
            x = _bconv(w, "Conv2d_3b_1x1", x)
            x = _bconv(w, "Conv2d_4a_3x3", x)
            x = _maxpool(x)
            for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
                x = _block_a(w, p, x)
            x = _block_b(w, "Mixed_6a", x)
            for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
                x = _block_c(w, p, x)
            x = _block_d(w, "Mixed_7a", x)
            for p in ("Mixed_7b", "Mixed_7c"):
                x = _block_e(w, p, x)
        return x.mean(dim=(2, 3))  # global average pool -> [B, 2048]

    def __call__(self, images) -> np.ndarray:
        return self.forward(images).cpu().numpy()


def synthetic_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random correctly-shaped weights (tests / shape validation): the JAX
    module's draws from the same numpy seed, in the same order."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, (cin, cout, (kh, kw), _, _) in CONV_SPECS.items():
        # He init: variance-preserving through the 94-conv relu chain, so
        # synthetic-weight runs see signal, not a collapsed constant
        out[f"{name}.w"] = rng.normal(
            0, np.sqrt(2.0 / (cin * kh * kw)), (kh, kw, cin, cout)
        ).astype(np.float32)
        out[f"{name}.scale"] = np.ones(cout, np.float32)
        out[f"{name}.shift"] = rng.normal(0, 0.01, cout).astype(np.float32)
    return out

"""InceptionV3 pool3 features for FID: the contract of the JAX package's
``utils/inception_jax.py`` when its weights are absent.

``InceptionV3Features.load_default`` raises ``FileNotFoundError`` while
``weights/inception_v3.npz`` is not in the repo, so ``MetricsCalculator``
takes the SynthNet stand-in, as the JAX package does. The network itself is
not ported yet: with the weights present, ``load_default`` raises
``NotImplementedError`` instead of computing another metric under its name.
"""

from __future__ import annotations

import torch

from rectified_flow_vision_tpu_torch.config import WEIGHTS_DIR

DEFAULT_WEIGHTS_PATH = WEIGHTS_DIR / "inception_v3.npz"


class InceptionV3Features:
    """InceptionV3 feature extractor (not ported yet)."""

    @classmethod
    def load_default(cls, device: str | torch.device = "cuda") -> "InceptionV3Features":
        if not DEFAULT_WEIGHTS_PATH.exists():
            raise FileNotFoundError(
                f"InceptionV3 weights not found at {DEFAULT_WEIGHTS_PATH}; "
                "run tools/convert_inception_weights.py with torchvision."
            )
        raise NotImplementedError(
            f"{DEFAULT_WEIGHTS_PATH} exists, but the InceptionV3 network is not ported to "
            "PyTorch yet: ROADMAP.md item A5 (the LPIPS and Inception networks)"
        )

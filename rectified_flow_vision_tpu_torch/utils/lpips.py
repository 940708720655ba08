"""LPIPS (AlexNet backbone): the contract of the JAX package's
``utils/lpips_jax.py`` when its weights are absent.

``LPIPS.load_default`` raises ``FileNotFoundError`` while
``weights/lpips_alex.npz`` is not in the repo, so ``MetricsCalculator``
takes the SynthNet stand-in, as the JAX package does. The network itself is
not ported yet: with the weights present, ``load_default`` raises
``NotImplementedError`` instead of computing another metric under its name.
"""

from __future__ import annotations

import torch

from rectified_flow_vision_tpu_torch.config import WEIGHTS_DIR

DEFAULT_WEIGHTS_PATH = WEIGHTS_DIR / "lpips_alex.npz"


class LPIPS:
    """Learned perceptual distance on AlexNet features (not ported yet)."""

    backbone_name = "alexnet"

    @classmethod
    def load_default(cls, device: str | torch.device = "cuda") -> "LPIPS":
        if not DEFAULT_WEIGHTS_PATH.exists():
            raise FileNotFoundError(
                f"LPIPS weights not found at {DEFAULT_WEIGHTS_PATH}; run "
                "tools/convert_lpips_weights.py on a machine with the lpips pip package."
            )
        raise NotImplementedError(
            f"{DEFAULT_WEIGHTS_PATH} exists, but the LPIPS network is not ported to "
            "PyTorch yet: ROADMAP.md item A5 (the LPIPS and Inception networks)"
        )

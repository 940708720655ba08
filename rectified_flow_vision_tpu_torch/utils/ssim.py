"""Structural similarity (SSIM), scikit-image-compatible, numpy-only: a copy
of the JAX package's ``utils/ssim.py``.

The reference calls ``skimage.metrics.structural_similarity`` with
``channel_axis=2, data_range=255`` (reference: utils/metrics.py:38-54).
scikit-image is not a dependency, so this implements the same algorithm
(Wang et al. 2004) with skimage's defaults: uniform 7x7 window, unbiased
covariance normalisation, edge crop of (win-1)//2, and per-channel
averaging for multichannel inputs.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def structural_similarity(
    im1: np.ndarray,
    im2: np.ndarray,
    *,
    win_size: int = 7,
    data_range: float = 255.0,
    channel_axis: int | None = None,
    K1: float = 0.01,
    K2: float = 0.03,
) -> float:
    if im1.shape != im2.shape:
        raise ValueError("Images must have the same size")
    # skimage raises on batched input too; without this, the edge crop
    # empties a small leading dim and the mean silently returns NaN.
    if im1.ndim - (0 if channel_axis is None else 1) > 2:
        raise ValueError(
            "structural_similarity expects one [H, W] or [H, W, C] image, "
            f"got shape {im1.shape}; loop over the batch instead"
        )

    if channel_axis is not None:
        n_ch = im1.shape[channel_axis]
        vals = [
            structural_similarity(
                np.take(im1, c, axis=channel_axis),
                np.take(im2, c, axis=channel_axis),
                win_size=win_size,
                data_range=data_range,
                K1=K1,
                K2=K2,
            )
            for c in range(n_ch)
        ]
        return float(np.mean(vals))

    x = im1.astype(np.float64)
    y = im2.astype(np.float64)
    ndim = x.ndim

    NP = win_size**ndim
    cov_norm = NP / (NP - 1)  # unbiased

    filt = lambda a: uniform_filter(a, size=win_size)  # noqa: E731
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2

    A1 = 2.0 * ux * uy + C1
    A2 = 2.0 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, s - pad) for s in S.shape)
    return float(S[crop].mean())

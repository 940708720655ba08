"""Test data: online photos or procedural synthetic images.

Counterpart of the JAX package's ``utils/download_data.py``. The synthetic
generator is the same recipe on the same ``numpy.random.Generator`` stream
(random background, then 3-7 random circles, rectangles or linear
gradients), so a seed gives the same pixels in both packages. Images are
written as ``image_{i:04d}.png`` with PIL. The picsum downloader needs the
network and ``requests``, imported only when it runs.
"""

from __future__ import annotations

import os
from io import BytesIO
from typing import Optional

import numpy as np

from rectified_flow_vision_tpu_torch import config as config_lib
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger

log = get_logger("flow_vision.data")


def download_picsum_images(save_dir: str, num_images: int = 100, size: int = 64) -> int:
    """Download random photos from https://picsum.photos (online mode)."""
    import requests  # local imports: offline runs never need them
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    log.info("Downloading %d images from Lorem Picsum...", num_images)

    successful = 0
    for i in range(num_images):
        try:
            resp = requests.get(f"https://picsum.photos/{size}/{size}", timeout=10)
            if resp.status_code == 200:
                img = Image.open(BytesIO(resp.content)).convert("RGB")
                img.save(os.path.join(save_dir, f"image_{i:04d}.png"))
                successful += 1
        except Exception as exc:  # noqa: BLE001 - per-image soft failure
            log.warning("Error downloading image %d: %s", i, exc)
            continue

    log.info("Downloaded %d/%d images successfully", successful, num_images)
    return successful


def _paint_circle(img: np.ndarray, rng: np.random.Generator, size: int) -> None:
    cx, cy = rng.integers(0, size, 2)
    radius = int(rng.integers(5, max(6, size // 3)))
    y, x = np.ogrid[:size, :size]
    mask = (x - cx) ** 2 + (y - cy) ** 2 <= radius**2
    img[mask] = rng.integers(0, 256, 3)


def _paint_rectangle(img: np.ndarray, rng: np.random.Generator, size: int) -> None:
    x1, y1 = rng.integers(0, max(1, size - 10), 2)
    x2 = min(int(x1 + rng.integers(10, max(11, size // 2))), size)
    y2 = min(int(y1 + rng.integers(10, max(11, size // 2))), size)
    img[y1:y2, x1:x2] = rng.integers(0, 256, 3)


def _paint_gradient(img: np.ndarray, rng: np.random.Generator, size: int) -> None:
    color = rng.integers(0, 256, 3).astype(np.float64)
    axis = int(rng.integers(0, 2))  # 0 = vertical ramp, 1 = horizontal ramp
    ramp = np.linspace(0.0, 1.0, size)
    grad = ramp.reshape(-1, 1, 1) if axis == 0 else ramp.reshape(1, -1, 1)
    blended = img.astype(np.float64) * (1.0 - grad) + color * grad
    img[:] = blended.astype(np.uint8)


_PAINTERS = (_paint_circle, _paint_rectangle, _paint_gradient)


def synthesize_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """One procedural image: random background + 3-7 random shapes."""
    img = np.empty((size, size, 3), dtype=np.uint8)
    img[:, :] = rng.integers(0, 256, 3)
    for _ in range(int(rng.integers(3, 8))):
        _PAINTERS[int(rng.integers(0, len(_PAINTERS)))](img, rng, size)
    return img


def generate_synthetic_images(
    save_dir: str,
    num_images: int = 100,
    size: int = 64,
    seed: Optional[int] = None,
    start_index: int = 0,
) -> int:
    """Generate procedural images (offline mode / online fallback)."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    log.info("Generating %d synthetic images...", num_images)

    rng = np.random.default_rng(seed)
    for i in range(num_images):
        Image.fromarray(synthesize_image(rng, size)).save(
            os.path.join(save_dir, f"image_{start_index + i:04d}.png")
        )

    log.info("Generated %d synthetic images", num_images)
    return num_images


def download_data(use_online: bool = True, config_path: Optional[str] = None) -> None:
    """Populate the config's data directory: picsum photos topped up with
    synthetic images when fewer than half arrive, synthetic on any error;
    synthetic only when offline."""
    cfg = config_lib.load_config(config_path)
    save_dir = str(config_lib.repo_root() / cfg.data.data_dir)
    num_images = cfg.data.num_mock_images
    size = cfg.data.image_size

    if use_online:
        try:
            downloaded = download_picsum_images(save_dir, num_images, size)
            if downloaded < num_images // 2:
                log.info("Few images downloaded; complementing with synthetic...")
                generate_synthetic_images(
                    save_dir, num_images - downloaded, size, start_index=downloaded
                )
        except Exception as exc:  # noqa: BLE001 - whole-run soft failure
            log.warning("Online download failed (%s); generating synthetic.", exc)
            generate_synthetic_images(save_dir, num_images, size)
    else:
        generate_synthetic_images(save_dir, num_images, size)

    log.info("Data saved in: %s", save_dir)
    log.info("Total images: %d", len(os.listdir(save_dir)))

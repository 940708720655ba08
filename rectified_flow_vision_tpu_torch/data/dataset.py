"""Image dataset and host-side batching (numpy only).

Counterpart of the JAX package's ``data/dataset.py``: the whole corpus is
decoded once into a contiguous NHWC float32 array in [-1, 1] (Resize ->
ToTensor -> Normalize(0.5, 0.5) of the reference), and an epoch is a
sequence of shuffled, fixed-shape batches. The last partial batch is dropped
during training. The trainers keep a corpus that fits on the card resident
there and gather batches by index (``models.base_flow.make_train_epoch``);
``batches`` serves the host path and gives the same permutation.

PIL is imported where an image file is decoded, so array corpora need none.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg")


def list_image_paths(image_dir: str | Path) -> List[Path]:
    paths: List[Path] = []
    for ext in _EXTS:
        paths.extend(sorted(Path(image_dir).glob(f"*{ext}")))
    return paths


def load_image(path: str | Path, image_size: int) -> np.ndarray:
    """Decode one image to float32 HWC in [-1, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


class ImageDataset:
    """In-memory NHWC image corpus in [-1, 1]: the reference ImageDataset's
    glob patterns and normalization; ``__getitem__`` returns one [H, W, C]
    float32 array."""

    def __init__(self, image_dir: str | Path, image_size: int = 64) -> None:
        self.image_dir = str(image_dir)
        self.image_size = image_size
        self.image_paths = list_image_paths(image_dir)
        if self.image_paths:
            self.images = np.stack([load_image(p, image_size) for p in self.image_paths])
        else:
            self.images = np.zeros((0, image_size, image_size, 3), dtype=np.float32)
        print(f"Dataset loaded: {len(self.image_paths)} images")

    @property
    def images_u8(self) -> np.ndarray:
        """uint8 copy of the corpus (for the native batch loader); rint
        before the cast, so f32 noise of the normalization cannot round a
        grey level down."""
        return np.clip(np.rint((self.images + 1.0) * 127.5), 0, 255).astype(np.uint8)

    def native_loader(self, batch_size: int, *, seed: int = 0, **kwargs):
        """The C++ prefetching batch loader over this corpus, or None when
        its library is not built (or the corpus is smaller than a batch)."""
        from rectified_flow_vision_tpu_torch.data.native_loader import (
            NativeBatchLoader,
            native_available,
        )

        if not native_available() or len(self) == 0 or batch_size > len(self):
            return None
        return NativeBatchLoader(self.images_u8, batch_size, seed=seed, **kwargs)

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.images[idx]

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = True,
        repeat_to_fill: bool = True,
    ) -> Iterator[np.ndarray]:
        """Yield fixed-shape [B, H, W, C] batches for one epoch. With
        ``repeat_to_fill`` a corpus smaller than one batch is tiled up to a
        full batch."""
        n = len(self)
        if n == 0:
            return
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        if n < batch_size and repeat_to_fill:
            idx = np.tile(idx, -(-batch_size // n))[:batch_size]
            n = batch_size
        end = n - (n % batch_size) if drop_last else n
        if drop_last and end == 0:
            return
        for start in range(0, end, batch_size):
            yield self.images[idx[start : start + batch_size]]

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self)
        if n == 0:
            return 0
        if n < batch_size:
            return 1
        return n // batch_size if drop_last else -(-n // batch_size)


class ArrayDataset:
    """An [N, H, W, C] array with the dataset protocol, so that it drives the
    same training paths as ``ImageDataset`` (the card-resident epoch only
    needs ``.images``)."""

    def __init__(self, images: np.ndarray) -> None:
        self.images = np.asarray(images, dtype=np.float32)
        if self.images.ndim != 4:
            raise ValueError("ArrayDataset expects [N, H, W, C]")

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.images[idx]

    batches = ImageDataset.batches
    num_batches = ImageDataset.num_batches

    def native_loader(self, batch_size: int, **kwargs):
        """Latents are float-valued; the uint8 C++ loader does not apply."""
        return None


def as_nchw(x: np.ndarray) -> np.ndarray:
    """NHWC -> NCHW (the public tensor API is NCHW, like the reference)."""
    return np.transpose(x, (0, 3, 1, 2))


def as_nhwc(x: np.ndarray) -> np.ndarray:
    """NCHW -> NHWC (the internal layout)."""
    return np.transpose(x, (0, 2, 3, 1))


def eval_reference_images(image_size: int, n: int) -> np.ndarray:
    """Held-out synthetic evaluation references (NHWC float32 in [-1, 1]).

    A deterministic set disjoint from the training corpus, from the same
    procedural recipe: ``data/eval_<size>/`` under the repo root, a pure
    function of (image_size, n) since generation is sequential from a fixed
    seed, regenerated whenever fewer than ``n`` images are present.
    """
    import shutil

    from rectified_flow_vision_tpu_torch import config
    from rectified_flow_vision_tpu_torch.utils.download_data import generate_synthetic_images

    d = config.repo_root() / "data" / f"eval_{image_size}"
    have = len(list_image_paths(d)) if d.exists() else 0
    if have < n:
        shutil.rmtree(d, ignore_errors=True)
        generate_synthetic_images(str(d), n, image_size, seed=4242 + image_size)
    return ImageDataset(str(d), image_size).images[:n]

"""Packed binary corpus: one mmap-able file for ImageNet-scale datasets.

A copy of the JAX package's ``data/packed.py`` (numpy only); files written
by either package read in the other.

The in-memory ``ImageDataset`` decodes every PNG up front — right for the
reference's 100-image corpora, wrong for ImageNet-class training
(BASELINE configs[3]) where the corpus exceeds RAM. A packed corpus is a
single file of raw uint8 NHWC frames behind a small header; reading it is
one ``np.memmap`` (pages fault in on demand), and the C++ batch pipeline
(data/native_loader.py) consumes the mapped array zero-copy — epochs
stream from disk at page-cache speed with no decode cost.

Format: 8-byte magic "RFVC0001", then 4 little-endian uint64 (N, H, W, C),
then N*H*W*C bytes of uint8 pixels.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

MAGIC = b"RFVC0001"
_HEADER = struct.Struct("<8sQQQQ")


def pack_corpus(
    image_dir: str | Path,
    out_path: str | Path,
    image_size: int,
    *,
    chunk: int = 256,
) -> int:
    """Pack a directory of images into a corpus file; returns image count.

    Streams in chunks so packing itself never holds the corpus in memory.
    """
    from rectified_flow_vision_tpu_torch.data.dataset import list_image_paths, load_image

    paths = list_image_paths(image_dir)
    if not paths:
        raise ValueError(f"no images under {image_dir}")

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    n = len(paths)
    with open(out_path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, n, image_size, image_size, 3))
        for start in range(0, n, chunk):
            batch = []
            for p in paths[start : start + chunk]:
                img = load_image(p, image_size)  # [-1,1] float32
                batch.append(
                    np.clip(np.rint((img + 1.0) * 127.5), 0, 255).astype(np.uint8)
                )
            f.write(np.stack(batch).tobytes())
    return n


class PackedCorpus:
    """Memory-mapped uint8 NHWC corpus + fixed-shape batch iteration."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            magic, n, h, w, c = _HEADER.unpack(f.read(_HEADER.size))
        if magic != MAGIC:
            raise ValueError(f"{path} is not a packed corpus (magic {magic!r})")
        self.shape = (int(n), int(h), int(w), int(c))
        self.images_u8 = np.memmap(
            self.path, dtype=np.uint8, mode="r", offset=_HEADER.size,
            shape=self.shape,
        )

    def __len__(self) -> int:
        return self.shape[0]

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self)
        if n == 0:
            return 0
        return n // batch_size if drop_last else -(-n // batch_size)

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = True,
    ) -> Iterator[np.ndarray]:
        """Float32 [-1,1] NHWC batches, gathering only the touched pages."""
        n = len(self)
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        end = n - (n % batch_size) if drop_last else n
        for start in range(0, end, batch_size):
            take = np.sort(idx[start : start + batch_size])  # page locality
            raw = self.images_u8[take]
            yield raw.astype(np.float32) / 255.0 * 2.0 - 1.0

    def native_loader(self, batch_size: int, *, seed: int = 0, **kwargs):
        """C++ prefetching loader over the mapped corpus (zero-copy)."""
        from rectified_flow_vision_tpu_torch.data.native_loader import (
            NativeBatchLoader,
            native_available,
        )

        if not native_available() or batch_size > len(self):
            return None
        return NativeBatchLoader(self.images_u8, batch_size, seed=seed, **kwargs)

"""ctypes bindings for the native C++ batch pipeline (csrc/databatch.cpp).

Shuffled, normalized ([0,255] uint8 -> [-1,1] float32 NHWC), prefetched
batches assembled by C++ worker threads behind a bounded ring — the
training thread only memcpy-receives ready batches. Falls back cleanly when
the shared library has not been built (``tools/build_native.sh``); the pure
-Python ``ImageDataset.batches`` path is always available.

Epoch shuffles are deterministic in (seed, epoch), matching the Python
pipeline's reproducibility contract.

A copy of the JAX package's ``data/native_loader.py``: the same C++ source
and the same library path under the repo root, so either package builds it
and both load it.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_LIB_PATH = _ROOT / "lib" / "librfv_data.so"
_SRC_PATH = _ROOT / "csrc" / "databatch.cpp"
_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def _try_build() -> bool:
    """Compile the native pipeline on first use (a few seconds of g++).

    The .so is a build artifact, not a committed binary; any environment
    with a C++ toolchain gets the native path automatically. Set
    RFV_NO_NATIVE_BUILD=1 to suppress (tests of the fallback path do).
    Concurrent builds race benignly: each compiles to its own temp file
    and os.replace() is atomic.
    """
    global _build_attempted
    if _build_attempted:
        return _LIB_PATH.exists()
    _build_attempted = True
    if os.environ.get("RFV_NO_NATIVE_BUILD"):
        return False
    if not _SRC_PATH.exists():
        return False
    import shutil
    import subprocess
    import tempfile

    gxx = shutil.which("g++")
    if gxx is None:
        return False
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.NamedTemporaryFile(
        dir=_LIB_PATH.parent, suffix=".so", delete=False
    )
    tmp.close()
    cmd = [
        gxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", str(_SRC_PATH), "-o", tmp.name,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp.name, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp.name)
        except OSError:
            pass
        return False


def native_available() -> bool:
    return _LIB_PATH.exists() or _try_build()


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.rfv_loader_create.restype = ctypes.c_void_p
        lib.rfv_loader_create.argtypes = [
            ctypes.c_void_p,  # corpus
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long,  # batch
            ctypes.c_uint64,  # seed
            ctypes.c_int,  # depth
            ctypes.c_int,  # workers
        ]
        lib.rfv_loader_batches_per_epoch.restype = ctypes.c_long
        lib.rfv_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.rfv_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.rfv_loader_next.restype = ctypes.c_int
        lib.rfv_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.rfv_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeBatchLoader:
    """Prefetching batch iterator over a uint8 NHWC corpus."""

    def __init__(
        self,
        corpus_u8: np.ndarray,
        batch_size: int,
        *,
        seed: int = 0,
        prefetch_depth: int = 4,
        workers: Optional[int] = None,
    ):
        if not native_available():
            raise FileNotFoundError(
                f"{_LIB_PATH} not built; run tools/build_native.sh"
            )
        corpus_u8 = np.ascontiguousarray(corpus_u8, dtype=np.uint8)
        if corpus_u8.ndim != 4:
            raise ValueError("corpus must be [N, H, W, C] uint8")
        n, h, w, c = corpus_u8.shape
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > corpus size {n}")
        self._corpus = corpus_u8  # keep alive: C++ borrows the pointer
        self.batch_size = batch_size
        self.shape = (batch_size, h, w, c)
        workers = workers or min(4, os.cpu_count() or 1)
        self._lib = _load_lib()
        self._handle = self._lib.rfv_loader_create(
            corpus_u8.ctypes.data_as(ctypes.c_void_p),
            n, h, w, c, batch_size,
            ctypes.c_uint64(seed),
            prefetch_depth,
            workers,
        )
        if not self._handle:
            raise RuntimeError("rfv_loader_create failed")
        self.batches_per_epoch = int(
            self._lib.rfv_loader_batches_per_epoch(self._handle)
        )

    def epoch(self, epoch: int) -> Iterator[np.ndarray]:
        """Yield this epoch's batches (deterministic shuffle in (seed, epoch))."""
        self._lib.rfv_loader_start_epoch(self._handle, epoch)
        out = np.empty(self.shape, np.float32)
        for _ in range(self.batches_per_epoch):
            rc = self._lib.rfv_loader_next(
                self._handle, out.ctypes.data_as(ctypes.c_void_p)
            )
            if rc != 0:
                break
            yield out.copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rfv_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

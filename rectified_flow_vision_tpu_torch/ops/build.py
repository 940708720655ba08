"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

The sources under ``ops/csrc/`` have a plain C interface (no PyTorch
headers), so each compiles in seconds. At first use, one ``nvcc -c`` per
source is started at once, the objects are linked into one shared library
under ``build/torch_kernels/`` at the repository root, and the library is
loaded with ctypes. The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is not.

There is no fallback: without ``nvcc`` the build raises, and a CUDA tensor
never silently takes a kernel's plain PyTorch version.

Each wrapper bumps its entry in ``LAUNCHES`` once per call that launches
its kernel(s), so a run can show that the main path went through them;
``gn_silu`` counts the calls that took the cluster plan, ``gn_silu_streamed``
those that took the streamed plan (a slab larger than one cluster holds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = (
    "gn_silu.cu", "gn_silu_dropout.cu", "conv3x3.cu", "attention.cu", "flash_attention.cu",
    "flash_attention_streamed.cu", "flash_attention_f32.cu", "flash_attention_f32_bwd.cu",
    "dropout.cu", "dit_glue.cu", "qk_norm_rope.cu", "runtime.cu",
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
)

LAUNCHES: Dict[str, int] = {
    "gn_silu": 0,
    "gn_silu_streamed": 0,
    "conv3x3": 0,
    "attention_block": 0,
    "gn_silu_dropout": 0,
    "gn_silu_backward": 0,
    "dropout_mask_apply": 0,
    "flash_attention": 0,
    "flash_attention_backward": 0,
    "dropout": 0,
    "ln_modulate": 0,
    "bias_act": 0,
    "gated_residual": 0,
    "qk_norm_rope": 0,
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _L = ctypes.c_uint32, ctypes.c_longlong
_SIGNATURES = {
    "rfv_gn_silu": [_P, _P, _P, _P, _P, _P, _L, ctypes.POINTER(_L), _I, _I, _I, _I, _F, _I, _P],
    "rfv_gn_silu_backward": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _F, _I, _I, _I, _P,
    ],
    "rfv_gn_silu_dropout": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _U, _F, _I, _I, _I, _P,
    ],
    "rfv_dropout_mask_apply": [_P, _P, _P, _I, _L, _U, _F, _I, _P],
    "rfv_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rfv_conv3x3_smem": [_I, _I],
    "rfv_attention_block": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    "rfv_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _F, _I, _P],
    "rfv_flash_attention_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _I,
        _P,
    ],
    "rfv_dropout": [_P, _P, _P, _L, _L, _U, _F, _I, _P],
    "rfv_ln_modulate": [_P, _P, _P, _P, _L, _I, _L, _L, _F, _I, _P],
    "rfv_bias_act": [_P, _P, _P, _L, _I, _I, _I, _P],
    "rfv_gated_residual": [_P, _P, _P, _P, _P, _L, _I, _L, _L, _I, _P],
    "rfv_qk_norm_rope": [_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH and "
        f"{cand}): the port's CUDA kernels are compiled from "
        f"{CSRC} at first use and need the CUDA toolkit"
    )


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if not already built) and return the library path."""
    nvcc = find_nvcc()
    tag = _digest(nvcc)
    lib_path = BUILD_DIR / f"librfv_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs: List[Path] = []
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
        objs.append(obj)
        procs.append(
            (
                src,
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
            )
        )
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rfv_error_string.argtypes = [ctypes.c_int]
            lib.rfv_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        text = library().rfv_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA kernel launch failed with error {code} ({text})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(
    t: torch.Tensor,
    name: str,
    *,
    device: torch.device,
    dtype: torch.dtype,
    shape: tuple,
) -> None:
    """Validate a kernel argument: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(x: torch.Tensor, kernel: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{kernel}: dtype {x.dtype} not supported (float32, bfloat16)")

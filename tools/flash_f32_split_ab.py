#!/usr/bin/env python3
"""Where the fp32 flash kernels split their operands, measured on one card.

    python3 tools/flash_f32_split_ab.py

The fp32 flash kernels up to head width 128 compute each product in 3xTF32
(x = hi + lo). They split every streamed tile once, when it lands in shared
memory (hi in place, lo beside it), so that the 8 warps reading it split
nothing (``ops/csrc/flash_f32_tc.cuh``). The other place is the registers,
after each fragment load. This script builds the shipped kernels and a copy
whose ``split_tile`` does nothing and whose tile products load the fp32
value and split it in registers (same accumulators, same barriers), links
each with the other flash objects into a library of its own, and times the
forward and the backward of both at DiT-S/2's (64, 1024, 6, 64) and
DiT-XL/2's (64, 1024, 16, 72) shapes with CUDA events, in turns (shipped,
registers, registers, shipped). Both are first held to the plain version.
Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (old, new) in flash_f32_tc.cuh: the register-split copy
REGISTER_SPLIT = (
    ("void split_tile(float* t, float* lo, int rows) {\n"
     "  constexpr int CH = DP / 4, P = pitch<DP>();\n"
     "  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {",
     "void split_tile(float* t, float* lo, int rows) {\n"
     "  constexpr int CH = DP / 4, P = pitch<DP>();\n"
     "  for (int i = threadIdx.x; i < 0; i += THREADS) {"),
    ("      uint32_t bhi[4], blo[4];\n      ldsm_x4(bhi, bh + 8 * j * P + 8 * kk);\n"
     "      ldsm_x4(blo, bl + 8 * j * P + 8 * kk);\n",
     "      uint32_t bf[4], bhi[4], blo[4];\n      ldsm_x4(bf, bh + 8 * j * P + 8 * kk);\n"
     "      split_tf32(bf, bhi, blo);\n"),
    ("          mma_3xtf32(big[n], small[n], ahi, alo, __float_as_uint(yh[o]),\n"
     "                     __float_as_uint(yh[o + P]), __float_as_uint(yl[o]),\n"
     "                     __float_as_uint(yl[o + P]));",
     "          const float bv[2] = {yh[o], yh[o + P]};\n"
     "          uint32_t bhi[2], blo[2];\n"
     "          split_tf32(bv, bhi, blo);\n"
     "          mma_3xtf32(big[n], small[n], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);"),
)
SHAPES = ((64, 1024, 6, 64), (64, 1024, 16, 72))
FLASH_SOURCES = ("flash_attention.cu", "flash_attention_streamed.cu", "flash_attention_f32.cu",
                 "flash_attention_f32_bwd.cu", "runtime.cu")


def variant_library(build) -> ctypes.CDLL:
    """The flash sources with REGISTER_SPLIT applied, compiled into a library
    under build/flash_f32_split_ab/."""
    work = ROOT / "build" / "flash_f32_split_ab"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(build.CSRC, work / "csrc")
    header = work / "csrc" / "flash_f32_tc.cuh"
    text = header.read_text()
    for old, new in REGISTER_SPLIT:
        if text.count(old) != 1:
            sys.exit(f"flash_f32_tc.cuh does not hold this code exactly once:\n{old}")
        text = text.replace(old, new)
    header.write_text(text)
    nvcc = build.find_nvcc()
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", str(work / "csrc" / src), "-o",
                               str(work / f"{src}.o")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for src in FLASH_SOURCES]
    for src, proc in zip(FLASH_SOURCES, procs):
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on the register-split copy of {src}:\n{out}")
    lib_path = work / "libflash_register_split.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared",
                    *(str(work / f"{src}.o") for src in FLASH_SOURCES), "-o", str(lib_path)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("rfv_flash_attention_fwd", "rfv_flash_attention_bwd"):
        getattr(lib, name).argtypes = build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.rfv_error_string.argtypes = [ctypes.c_int]
    lib.rfv_error_string.restype = ctypes.c_char_p
    return lib


def main() -> None:
    import torch

    from rectified_flow_vision_tpu_torch.ops import build
    from rectified_flow_vision_tpu_torch.ops import flash_attention as FA

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = {"shared memory": build.library(), "registers": variant_library(build)}

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for shape in SHAPES:
        b, t, h, d = shape
        q, k, v = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").unbind(2)
        data[shape] = (q, k, v, torch.randn((b, t, h, d), generator=gen, device="cuda"))
    readings = {(side, shape): [] for side in libs for shape in SHAPES}
    for side in ("shared memory", "registers", "registers", "shared memory"):
        build._lib = libs[side]
        for shape in SHAPES:
            q, k, v, g = data[shape]
            out, lse = FA.flash_attention_cuda(q, k, v)
            want = FA.flash_attention_plain(q[:2], k[:2], v[:2])
            if not torch.allclose(out[:2], want, rtol=1e-4, atol=1e-4):
                sys.exit(f"{side}: forward at {shape} differs from the plain version")
            readings[(side, shape)].append(
                (ms(lambda: FA.flash_attention_cuda(q, k, v)),
                 ms(lambda: FA.flash_attention_backward_cuda(q, k, v, out, lse, g))))
    build._lib = libs["shared memory"]
    for shape in SHAPES:
        row = []
        for side in libs:
            fwd = statistics.median(r[0] for r in readings[(side, shape)])
            bwd = statistics.median(r[1] for r in readings[(side, shape)])
            each = [tuple(round(x, 4) for x in r) for r in readings[(side, shape)]]
            row.append(f"split in {side}: forward {fwd:.4f} ms, backward {bwd:.4f} ms "
                       f"(readings {each})")
        print(f"fp32 flash {shape}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device time of the GroupNorm dropout kernels in two checkouts, in turns.

    python3 tools/gn_dropout_ab.py PARENT_ROOT [CHANGE_ROOT] [--rounds N]

Each root is a checkout that holds ``rectified_flow_vision_tpu_torch/``
(``CHANGE_ROOT`` defaults to this file's checkout). Children run in the
order parent, change, change, parent, repeated ``--rounds`` times (default
2), each in a process of its own on that checkout's kernels (built by the
first child of each root). A child takes 8 readings, in bf16 at batch 256,
of each of:

- ``gn_drop_fwd_ms``: ``gn_silu_dropout_cuda`` summed over the 14 dropout
  sites of a flagship UNet train step;
- ``gn_drop_bwd_ms``: ``gn_silu_dropout_backward_cuda`` over the same sites
  (the backward kernel regenerating the mask);
- ``gn_fwd_ms``: ``gn_silu_cuda`` over the same shapes (the same kernel
  body without the mask: a control).

A reading is CUDA events around at least 10 calls and 100 ms of them a
shape. Two versions are only comparable within one run on one card, so the
card's name and power limit are printed first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from rectified_flow_vision_tpu_torch.ops import gn_silu as G, gn_silu_dropout as D

def kernel_ms(fn):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    reps = min(5000, max(10, int(100.0 / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

SITES = {(16, 16, 256): 5, (32, 32, 128): 4, (64, 64, 64): 5}  # a train step's dropout sites
g = torch.Generator(device="cuda").manual_seed(3)
args = {}
for (h, w, c), n in SITES.items():
    x = torch.randn((256, h, w, c), generator=g, device="cuda").bfloat16()
    s = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
    b = 0.1 * torch.randn(c, generator=g, device="cuda")
    y, stats = D.gn_silu_dropout_cuda(x, s, b, 7, 0.1)
    cot = (y.float() + 0.1 * torch.randn(y.shape, generator=g, device="cuda")).bfloat16()
    args[(h, w, c)] = (n, x, s, b, stats, cot)
out = {"gn_drop_fwd_ms": [], "gn_drop_bwd_ms": [], "gn_fwd_ms": []}
for _ in range(8):
    for key, fn in (("gn_drop_fwd_ms", lambda x, s, b, st, cot: D.gn_silu_dropout_cuda(x, s, b, 7, 0.1)),
                    ("gn_drop_bwd_ms", lambda x, s, b, st, cot: D.gn_silu_dropout_backward_cuda(x, cot, s, b, st, 7, 0.1)),
                    ("gn_fwd_ms", lambda x, s, b, st, cot: G.gn_silu_cuda(x, s, b))):
        out[key].append(sum(n * kernel_ms(lambda: fn(x, s, b, st, cot))
                            for n, x, s, b, st, cot in args.values()))
print(json.dumps(out))
"""

METRICS = ("gn_drop_fwd_ms", "gn_drop_bwd_ms", "gn_fwd_ms")


def main() -> None:
    argv = sys.argv[1:]
    rounds = 2
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        del argv[i:i + 2]
    if len(argv) not in (1, 2):
        sys.exit(__doc__)
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) == 2 else Path(__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    readings = {side: {m: [] for m in METRICS} for side in ("parent", "change")}
    for side in ("parent", "change", "change", "parent") * rounds:
        root = parent if side == "parent" else change
        res = subprocess.run([sys.executable, "-c", CHILD, str(root)], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            sys.exit(f"{side} ({root}) failed:\n{res.stdout}\n{res.stderr}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        for m in METRICS:
            readings[side][m] += got[m]
        print(f"{side:6s} " + ", ".join(f"{m} median {statistics.median(got[m]):.4f}"
                                        for m in METRICS), flush=True)
    summary = {"card": card}
    for m in METRICS:
        med = {side: statistics.median(readings[side][m]) for side in readings}
        summary[m] = {"parent": readings["parent"][m], "change": readings["change"][m],
                      "parent_median": med["parent"], "change_median": med["change"],
                      "change_over_parent": med["change"] / med["parent"]}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

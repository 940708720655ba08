#!/usr/bin/env python3
"""Serving throughput of two checkouts of the PyTorch port on one card, in turns.

    python3 tools/torch_serve_ab.py PARENT_ROOT [CHANGE_ROOT]

Each root is a checkout that holds ``rectified_flow_vision_tpu_torch/``
(``CHANGE_ROOT`` defaults to this file's checkout). The order is parent,
change, change, parent, each in a process of its own that builds that
checkout's kernels, makes the flagship UNet (64x64, random weights from seed
0) and reads ``SamplerService.throughput(4)`` at batch 256 in bf16 three
times. Two versions are only comparable within one run on one card, so the
card's name and power limit are printed first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from rectified_flow_vision_tpu_torch.models import BaseFlowModel
from rectified_flow_vision_tpu_torch.serving import SamplerService
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
model = BaseFlowModel(image_size=64, seed=0, sample_dtype="bfloat16", device="cuda")
svc = SamplerService(model, step_counts=(4,), batch_size=256, seed=0)
print(json.dumps([svc.throughput(4) for _ in range(3)]))
"""


def main() -> None:
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    change = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else Path(__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    readings = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        root = parent if side == "parent" else change
        res = subprocess.run(
            [sys.executable, "-c", CHILD, str(root)], cwd=root, capture_output=True, text=True,
            timeout=600,
        )
        if res.returncode != 0:
            sys.exit(f"{side} ({root}) failed:\n{res.stdout}\n{res.stderr}")
        rates = json.loads(res.stdout.strip().splitlines()[-1])
        readings[side] += rates
        print(f"{side:6s} {root}: throughput(4) img/s {rates}", flush=True)
    med = {k: statistics.median(v) for k, v in readings.items()}
    print(json.dumps({"card": card, "parent_img_s": readings["parent"],
                      "change_img_s": readings["change"], "parent_median": med["parent"],
                      "change_median": med["change"],
                      "change_over_parent": med["change"] / med["parent"]}))


if __name__ == "__main__":
    main()

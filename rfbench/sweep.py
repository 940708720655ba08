"""The knee of a serving cell: the highest request rate its system sustains.

    python3 rfbench/sweep.py --workload <cell> --seconds <s> --rates <r> ...

Sets the cell up once, then offers each rate (requests a second) for
``--seconds`` with the cell's traffic otherwise unchanged, and prints per
rate the images returned a second against those offered, the p50 and p95
latency, how late the senders ran, and the p95 of the last third of the
requests against the first third (a backlog that grows shows there). A rate
is sustained while nearly all it offers returns and the tail does not grow.
The cells' rates were set once from this, low enough that a batcher call
carries one batch (a quarter of the UNet's knee, 3/8 of the DiT's); the
benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args(argv)
    import torch

    from rfbench import core

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.cell(args.workload)
    run = core.kind(cell.traffic["kind"]).Run(cell, args.seed, torch.device("cuda", 0))
    run.setup()
    base = dict(cell.traffic)
    for rate in args.rates:
        run.tr = dict(base, rate_per_s=rate)
        got = run.window(args.seconds, False)
        ok = [r for r in run.requests if r["error"] is None]
        lat = np.array([r["t1"] - r["due"] for r in ok]) * 1e3
        third = max(1, len(lat) // 3)
        offered = rate * float(np.mean([r["n"] for r in run.requests]))
        print(json.dumps({
            "rate_per_s": rate, "offered_img_per_s": offered,
            "returned_img_per_s": got["info"]["returned_img_per_s"],
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p95_first_third_ms": float(np.percentile(lat[:third], 95)),
            "p95_last_third_ms": float(np.percentile(lat[-third:], 95)),
            "failed": got["failed"], **got["info"]}), flush=True)
    run.free()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())

"""Readings that the correctness limits are set from, for one cell.

    python3 rfbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] [--controls fp8 half_batch]

For every seed, in one process: the cell's set-up, a window of ``--seconds``
at the cell's own load (training needs none: 0), and the check, whose numbers
are the program's readings (the lower end of a limit). For each control seed
besides, the same numbers of the control, the reference computed in emulated
fp8 in the program's place (``Numerics(fp8=True)``), and, for training, of
the planted fault of a loss taken over half of each batch (the upper end);
``--controls`` picks which of the two a control seed reads.
A state left unchanged reads 1 on the change numbers by their definition.
Prints one JSON line per seed, then the largest program reading and the
smallest control or fault reading of each number. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device, control: bool,
             controls=("fp8", "half_batch")) -> dict:
    from rfbench import core
    from rfbench.kinds import serve_open_loop, train_epochs
    from rfbench.reference.numerics import Numerics, exact_fp32

    run = core.kind(cell.traffic["kind"]).Run(cell, seed, device)
    run.setup()
    run.window(seconds, False)
    run.free()
    out = {"seed": seed, "program": {k: v for k, (v, _) in run.check().items()}}
    if isinstance(run, train_epochs.Run):
        out["losses"] = {"program": run.prog["losses"], "reference": run.ref["losses"]}
    if not control:
        return out
    if isinstance(run, serve_open_loop.Run):
        with exact_fp32():
            fp8 = run.images(Numerics(fp8=True))
        out["control"] = {"img_rel_rms": serve_open_loop.rel_error(fp8, run.evidence["reference"])}
    elif isinstance(run, train_epochs.Run):
        if "fp8" in controls:
            fp8 = run.reference(Numerics(fp8=True))
            out["control"] = run.readings(fp8, run.ref)
            out["losses"]["control"] = fp8["losses"]
        if "half_batch" in controls:
            half = run.reference(Numerics(), use_rows=cell.traffic["batch"] // 2)
            out["half_batch"] = run.readings(half, run.ref)
            out["losses"]["half_batch"] = half["losses"]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--controls", nargs="+", choices=("fp8", "half_batch"),
                        default=["fp8", "half_batch"])
    args = parser.parse_args(argv)
    import torch

    from rfbench import core

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.cell(args.workload)
    device = torch.device("cuda", 0)
    lower, upper = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        r = readings(cell, seed, args.seconds, device, seed in args.control_seeds, args.controls)
        print(json.dumps(r), flush=True)
        if seed in args.seeds:
            for k, v in r["program"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        for part in ("control", "half_batch"):
            for k, v in r.get(part, {}).items():
                upper.setdefault(k, {})[part] = min(upper.get(k, {}).get(part, float("inf")), v)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())

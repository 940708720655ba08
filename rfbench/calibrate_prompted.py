"""Readings that a prompted serving cell's limits are set from.

    python3 rfbench/calibrate_prompted.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...]

``calibrate.py`` for a cell of kind ``serve_prompted_open_loop``: for every
seed, in one process, the cell's set-up, a window of ``--seconds`` at its own
load and the check, whose numbers are the program's readings (the lower end
of a limit); for each control seed besides, the reference in emulated fp8
(the upper end) and two planted faults, each against the sound reference:
two requests' prompts swapped, and RoPE left out. Prints one JSON line per
seed, then the largest program reading and the smallest control and fault
readings. The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    import torch

    from rfbench import core
    from rfbench.kinds import serve_open_loop
    from rfbench.reference.numerics import Numerics, exact_fp32

    if not torch.cuda.is_available():
        print("calibrate_prompted: needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.cell(args.workload)
    device = torch.device("cuda", 0)
    lower, upper = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        run = core.kind(cell.traffic["kind"]).Run(cell, seed, device)
        run.setup()
        run.window(args.seconds, False)
        run.free()
        out = {"seed": seed, "program": {k: v for k, (v, _) in run.check().items()}}
        if seed in args.control_seeds:
            with exact_fp32():
                fp8 = run.images(Numerics(fp8=True))
            out["control"] = {"img_rel_rms": serve_open_loop.rel_error(fp8, run.evidence["reference"])}
            out.update(run.faults())
        print(json.dumps(out), flush=True)
        if seed in args.seeds:
            for k, v in out["program"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        for k in ("swapped_prompts", "no_rope"):
            if k in out:
                upper[k] = min(upper.get(k, float("inf")), out[k])
        if "control" in out:
            upper["fp8"] = min(upper.get("fp8", float("inf")), out["control"]["img_rel_rms"])
        del run
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())

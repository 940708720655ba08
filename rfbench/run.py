"""Run one cell of the benchmark once and print its result line.

    python3 rfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed, the program's objects, one pass over every
shape the cell uses) counts as ``setup_s``, from process start to the first
timed call. The window then lasts ``--seconds``. With ``--trace 0`` the
result carries the cell's end-to-end metrics; with ``--trace 1`` a slice of
the window runs under the profiler and the result carries the per-layer
metrics, ``busy_s`` / ``window_s`` and a ``breakdown``. After the window the
program's state is freed and the reference checks what the window produced;
each number compared is printed with its limit, last on stderr and last in
the result line. The last line of stdout is the result, one JSON object.

Needs an NVIDIA card (exits 2 without one) and the port's package beside
this directory. The port's kernel library is built once per checkout under
``build/torch_kernels/``; any Triton cache goes to ``build/triton_cache/``.
A run that had to build the library says so (``kernels_built`` in the
result line): its ``setup_s`` holds the build and stands apart from the
others'. The set-up's phases are printed on stderr.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KERNEL_LIBS = ROOT / "build" / "torch_kernels"
LIBS_AT_START = set(KERNEL_LIBS.glob("librfv_kernels_*.so"))
PHASES: dict = {}  # set-up phase -> the clock at its end, in order
FORBIDDEN = ("jax", "jaxlib", "flax", "rectified_flow_vision_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, traced: bool, device, start: float) -> dict:
    """Set up, measure, check. Returns the result object (without ``card``)."""
    import torch

    from rfbench import core

    run = core.kind(cell.traffic["kind"]).Run(cell, seed, device)
    run.phases = dict(PHASES, harness_imports=time.perf_counter())
    run.setup()
    setup_s = time.perf_counter() - start
    marks = [("start", start)] + list(run.phases.items()) + [("setup_end", start + setup_s)]
    phases = {name: round(t - marks[i][1], 3) for i, (name, t) in enumerate(marks[1:])}
    print(f"rfbench: setup_s {setup_s:.3f} by phase {json.dumps(phases)}", file=sys.stderr)
    got = run.window(seconds, traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run.free()
    # a reading without a limit in the cell's limits file is printed and not compared
    readings = run.check()
    checks = {k: (v, lim) for k, (v, lim) in readings.items() if lim is not None}
    print("rfbench: not compared " + json.dumps(
        {k: v for k, (v, lim) in readings.items() if lim is None}), file=sys.stderr)
    correct = got["failed"] == 0 and got["attempted"] > 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": got["attempted"], "failed": got["failed"],
              "kernels_built": bool(set(KERNEL_LIBS.glob("librfv_kernels_*.so")) - LIBS_AT_START)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if not traced:
        values = dict(got["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif got["observed"].summary is not None:
        obs, summary = got["observed"], got["observed"].summary
        obs.peak_bytes = int(peak)
        for m in cell.per_layer:
            value = core.metric_reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result.update(metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    if "info" in got:
        print(f"rfbench: window {json.dumps(got['info'])}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    import torch

    PHASES["import_torch"] = time.perf_counter()
    from rfbench import core

    cell = core.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.cuda.init()
    PHASES["cuda_init"] = time.perf_counter()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      PROCESS_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"rfbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card()
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # not this directory: its module names are the package's
    sys.exit(main())

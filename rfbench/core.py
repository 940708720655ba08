"""What a run is made of, found by name: the manifest, a cell's configuration,
traffic and limits, the traffic's kind, and the per-layer metric readers.

    BENCHMARK.json                  the cells and the metrics
    rfbench/configs/<config>.json   a configuration (program and reference)
    rfbench/traffic/<traffic>.json  a traffic mix: its ``kind`` and parameters
    rfbench/kinds/<kind>.py         the code that drives a kind of traffic
    rfbench/limits/<cell>.json      the limits of the cell's correctness checks
    rfbench/metrics/<metric>.py     the reader of one per-layer metric
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    """One cell and everything that belongs to it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    cells = metric.get("workloads")
    if cells is not None:
        return cell in cells
    return metric.get("moves") in reported


def cell(name: str) -> Cell:
    """The cell ``name`` of the manifest, with its files read."""
    m = manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    e2e = [x for x in m["end_to_end"] if "workloads" not in x or name in x["workloads"]]
    reported = {x["name"] for x in e2e}
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=read_json(ROOT / conf["file"]),
        traffic=read_json(PACKAGE / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(PACKAGE / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=[x for x in m["per_layer"] if _applies(x, name, reported)],
    )


def kind(name: str):
    """The module that drives traffic of kind ``name``."""
    return importlib.import_module(f"rfbench.kinds.{name}")


def metric_reader(name: str):
    """``read(run) -> float | None`` of the per-layer metric ``name``."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Observed:
    """What a traced run saw, for the per-layer readers: the reduced trace
    of a slice after the window, the config and traffic, per-call records of
    the harness (``calls``: dicts with ``images`` or ``steps``, ``launches``
    (the program's launch counters moved by the call) and, for serving,
    ``batcher`` (the batcher's counters when the call began) and
    ``seconds`` (from the call to its output on the host)), the run's peak
    memory, the window's rate in images a second, and (serving) ``timed``:
    the records of the calls made in the measured window, which ran without
    the profiler."""

    config: dict
    traffic: dict
    summary: Any
    calls: List[dict]
    peak_bytes: int
    rate: float
    timed: List[dict] = field(default_factory=list)

    def window_calls(self) -> List[dict]:
        return [self.calls[i] for i in self.summary.calls]

    def launches(self, kernel: str) -> int:
        return sum(c["launches"].get(kernel, 0) for c in self.window_calls())

    def total(self, key: str) -> int:
        return sum(c[key] for c in self.window_calls())


def phase_marker(run):
    """``mark(name)``: records in ``run.phases`` (a dict, where the harness
    gives one) the clock at the end of a set-up phase; phases follow in
    order, each measured from the end of the one before."""
    phases = getattr(run, "phases", None)

    def mark(name: str) -> None:
        if phases is not None:
            phases[name] = time.perf_counter()

    return mark


def launch_counts() -> Dict[str, int]:
    """The program's per-wrapper launch counters (a copy)."""
    from rectified_flow_vision_tpu_torch.ops import build

    return dict(build.LAUNCHES)


def launch_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}

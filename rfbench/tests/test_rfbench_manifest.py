"""BENCHMARK.json against the contract's form, and every file it names."""

import re

from conftest import CELLS
from rfbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
M = core.manifest()


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["rfbench"] and 1 <= M["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in M["command"]) and len(M["command"]) <= 32
    assert (core.ROOT / M["command"][1]).is_file()


def test_names_units_and_text_fields():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1 and TEXT.match(w["why"])
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and TEXT.match(c["source"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


def test_every_cell_reports_setup_another_metric_and_a_per_layer_one():
    for name in CELLS:
        cell = core.cell(name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


def test_every_named_file_is_there():
    for c in M["configs"]:
        cfg = core.read_json(core.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
    for name in CELLS:
        cell = core.cell(name)
        assert core.kind(cell.traffic["kind"]).Run
        assert cell.limits
    for m in M["per_layer"]:
        assert callable(core.metric_reader(m["name"]))

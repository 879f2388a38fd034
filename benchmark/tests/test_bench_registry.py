"""BENCHMARK.json names what the harness finds, in the contract's form."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_and_entry_keys():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_text():
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS + PER_LAYER
             + [m["name"] for m in BENCH["end_to_end"]])
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cell = harness.cell(workload)
    drv = harness.driver(cell.traffic)
    for fn in ("setup", "window", "work", "release", "check"):
        assert callable(getattr(drv, fn))
    assert drv.FAULTS
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert cell.limits["compare"], "a cell's limits name the numbers it compares"
    config_entry = next(c for c in BENCH["configs"] if c["name"] == workload.split(".")[0])
    assert os.path.isfile(os.path.join(harness.ROOT, config_entry["file"]))
    assert cell.config["reduced"] == config_entry["reduced"]


@pytest.mark.parametrize("metric", PER_LAYER)
def test_metric_reader_found_by_name(metric):
    reader = harness.metric_reader(metric)
    assert callable(reader.read)


def test_every_config_used_and_layers_consistent():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and m["workloads"]
        for w in m["workloads"]:
            assert w in WORKLOADS

"""What every cell shares: ``BENCHMARK.json`` and the files it names,
spans, the check against the limits, and the result line.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The harness finds ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``driver`` names ``drivers/<driver>.py``), ``limits/<cell>.json``
and, for a traced run, ``metrics/<metric>.py`` for each per-layer metric
that the cell reports, all by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "shapegan_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, cell: str) -> bool:
    """Whether a cell reports a metric: listed under its ``workloads``;
    without that key (``setup_s``), every cell."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    workload = matches[0]
    config_entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = load_json(os.path.join(ROOT, config_entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{workload['traffic']}.json"))
    limits = load_json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, workload, config, traffic, limits, e2e, per_layer)


def driver(traffic: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def metric_reader(name: str):
    """The module ``metrics/<name>.py``, or, where there is none, the one of
    the name without its last dotted part (``mfu.train`` falls back to
    ``mfu.py``: one reader for a quantity split by cell). Names hold dots, so
    it is loaded by path; its ``read(reading)`` returns a number or None."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.isfile(path) and "." in name:
        path = os.path.join(BENCH_DIR, "metrics", f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spans:
    """Named spans timed on the device's clock (CUDA events; on the CPU,
    in tests, the host clock), read once the window has closed."""

    def __init__(self, device, annotate: bool = False):
        import torch

        self._cuda = device.type == "cuda"
        self._torch = torch
        self._annotate = annotate
        self._open: Dict[str, object] = {}
        self._ranges: Dict[str, object] = {}
        self.pairs: Dict[str, List[tuple]] = {}

    def _mark(self):
        if self._cuda:
            event = self._torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def begin(self, name: str) -> None:
        """Open ``name`` (with ``annotate``, also as a profiler span)."""
        if self._annotate:
            self._ranges[name] = self._torch.profiler.record_function(name)
            self._ranges[name].__enter__()
        self._open[name] = self._mark()

    def end(self, name: str) -> None:
        self.pairs.setdefault(name, []).append((self._open.pop(name), self._mark()))
        if self._annotate:
            self._ranges.pop(name).__exit__(None, None, None)

    def seconds(self, name: str) -> List[float]:
        """Each span's length (call after a synchronize)."""
        if self._cuda:
            return [a.elapsed_time(b) * 1e-3 for a, b in self.pairs.get(name, [])]
        return [b - a for a, b in self.pairs.get(name, [])]


@dataclass
class Reading:
    """What a traced run hands the per-layer metrics' readers."""
    cell: str
    window_s: float
    counts: Dict[str, float]
    spans: Dict[str, List[float]]
    work: Dict[str, tuple]                # operation -> (flops, bytes) in the window
    model_flops: float                    # the whole step's operations in the window
    device: Optional[object] = None       # profiling.DeviceReading


def judge(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, checks): each number with a limit beside it; correct when
    every compared number is finite and at most its limit."""
    checks, correct = {}, True
    for name, spec in limits["compare"].items():
        value = float(numbers.get(name, math.inf))
        ok = math.isfinite(value) and value <= spec["limit"]
        correct &= ok
        checks[name] = {"value": value, "limit": spec["limit"]}
    return correct, checks


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})

"""A run with the timed path broken underneath comes out not correct, once
for each fault that a cell can have; and a sound run on the CPU compares
within the program's bf16 rounding. The harness's look for a chip is
skipped: these drive ``run.run`` on the CPU at small sizes (tiny.py), with
the cells' own limits."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

import run  # benchmark/run.py, on the path through conftest

CASES = [(w, f) for w in tiny.SIZES for f in harness.driver(harness.cell(w).traffic).FAULTS]


def _run(cell, seed=2**31 + 21):
    return run.run(cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_turns_correct_false(workload, fault):
    cell = tiny.cell(workload)
    with harness.driver(cell.traffic).FAULTS[fault]():
        result = _run(cell)
    assert result["correct"] is False, result["checks"]
    assert list(result)[-1] == "checks"


# A 16 x 16 frame is mostly silhouette: the frame's limits, set at 800^2,
# mean nothing there (test_bench_reference.py holds the frame instead).
@pytest.mark.parametrize("workload", ["hpgan64.train", "hpgan64.generate"])
def test_sound_run_on_the_cpu_is_correct(workload):
    result = _run(tiny.cell(workload))
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == set(harness.cell(workload).limits["compare"])

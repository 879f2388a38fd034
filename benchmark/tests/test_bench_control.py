"""Each control comes out not correct: the float32 reference, put in the
program's place in the nearest precision below the configuration's (for
training also with the critic alone lowered), at each cell's own size on
the card. Run on the chip:

    python -m pytest benchmark/tests/test_bench_control.py -m gpu
"""

import pytest

from benchmark import harness

CASES = [(w["name"], c) for w in harness.benchmark()["workloads"]
         for c in harness.driver(harness.cell(w["name"]).traffic).CONTROLS]


@pytest.mark.gpu
@pytest.mark.parametrize("workload,control", CASES)
def test_control_is_not_correct(workload, control):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    import calibrate

    row = calibrate.reading(harness.cell(workload), 2**31 + 31, control, 1.0,
                            torch.device("cuda", 0))
    assert row["correct"] is False, row["numbers"]

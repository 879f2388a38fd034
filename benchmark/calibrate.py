#!/usr/bin/env python3
"""The readings that a cell's limits are set from (PERF.md, section 2):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --modes program,control,fault:<name> [--seconds 2]

For each mode and seed, in one process: the cell's set-up from the seed,
a short window at the cell's own load (none for training, whose record is
made in set-up), and the numbers that decide ``correct``:

* ``program``: the program, as a run makes them (the lower readings);
* a control of the driver's ``CONTROLS`` (``control``, and for training
  ``control_critic``): the float32 reference put in the program's place,
  computed in the nearest precision below the configuration's, on the
  inputs that the window's check compares (the upper ones);
* ``fault:<name>``: the program with a fault planted under the timed path
  (the driver's ``FAULTS``).

Prints one JSON line per reading and, per mode, the largest and smallest
reading of each number. It needs CUDA, as run.py does; the benchmark's
tests call :func:`reading` on the CPU at small sizes."""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(cell, seed: int, mode: str, seconds: float, device) -> dict:
    """The numbers of one seed in one mode, with the judgement by the
    cell's limits."""
    from benchmark import harness

    drv = harness.driver(cell.traffic)
    plant = contextlib.nullcontext()
    if mode.startswith("fault:"):
        plant = drv.FAULTS[mode.split(":", 1)[1]]()
    with plant:
        state = drv.setup(cell, seed, device)
        if seconds > 0:
            drv.window(state, seconds)
        drv.release(state)
        numbers = drv.check(state, control=drv.CONTROLS.get(mode))
    correct, _ = harness.judge(numbers, cell.limits)
    return {"mode": mode, "seed": seed, "numbers": numbers, "correct": correct}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--modes", default="program")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from run import cache_dirs

    cache_dirs()
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for mode in args.modes.split(","):
        rows = []
        for seed in seeds:
            t0 = time.perf_counter()
            row = reading(harness.cell(args.workload), seed, mode, args.seconds, device)
            row["seconds"] = round(time.perf_counter() - t0, 2)
            rows.append(row)
            print(json.dumps(row), flush=True)
        names = rows[0]["numbers"]
        summary = {k: {"max": max(r["numbers"][k] for r in rows),
                       "min": min(r["numbers"][k] for r in rows)} for k in names}
        print(json.dumps({"mode": mode, "seeds": len(rows), "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

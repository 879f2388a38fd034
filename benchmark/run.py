#!/usr/bin/env python3
"""One run of one benchmark cell of shapegan_tpu_torch on one NVIDIA H100:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's weights and inputs on the card from ``--seed``, warms
up the cell's own shapes (set-up: everything before the window, the
kernels' build on a checkout's first run included), drives the cell's
traffic for ``--seconds`` seconds, frees the program, checks what the
window produced against the float32 reference, and prints one JSON line:
the end-to-end metrics (``--trace 0``) or the per-layer metrics, read from
a torch.profiler trace of the window (``--trace 1``). It fails without a
CUDA device; it never falls back to the CPU."""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def run(cell, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """Set up, measure, check; returns the result line's object. The CPU
    is accepted here (the benchmark's tests); the command line refuses it."""
    import torch

    from benchmark import harness, profiling

    drv = harness.driver(cell.traffic)
    state = drv.setup(cell, seed, device)
    setup_s = time.perf_counter() - started
    spans = harness.Spans(device, annotate=trace) if trace else None
    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    try:
        with torch.profiler.record_function(profiling.WINDOW):
            out = drv.window(state, seconds, spans)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    drv.release(state)
    numbers = drv.check(state)
    correct, checks = harness.judge(numbers, cell.limits)

    metrics = {}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell.workload["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(out["units"]), "failed": 0}
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else out["metrics"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        reading_dev = profiling.read(prof, spans=set(spans.pairs))
        work, model = drv.work(state, numbers)
        reading = harness.Reading(cell.name, out["window_s"], dict(state.counts),
                                  {name: spans.seconds(name) for name in spans.pairs},
                                  work, model, reading_dev)
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info["busy_s"] = reading_dev.busy_s
        device_info["window_s"] = reading_dev.window_s
        result["breakdown"] = reading_dev.breakdown()
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"run.py: the process loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

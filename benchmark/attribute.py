#!/usr/bin/env python3
"""Where a traced window's device time and idle time go, by the program's
own spans (``shapegan_tpu_torch.tracing``), on one CUDA device:

    python3 benchmark/attribute.py --workload hpgan64.train --seed 7 --seconds 20

It sets a cell up as ``run.py`` does, profiles its window (the CPU and
the device, as a ``--trace 1`` run does), and prints one JSON line:

* ``span_device_s``: each program span's device seconds (:func:`span_device_seconds`);
* ``kernel_spans_s`` beside ``port_kernels_s``: the device time given to
  the ``sg.kernel.*`` spans, and that of the hand kernels that
  ``readers.PORT_KERNELS`` names: equal when every ctypes launch is seen;
* ``span_host_s``: each program span's calls and host seconds;
* ``idle_gaps``: idle seconds by ``benchmark span/program span/host
  event`` at the gap's midpoint (``-`` where no program span holds it),
  and ``idle_outside_program_s``, the idle time that no program span holds;
* ``busy_s``, ``window_s`` and ``units`` as the traced run reads them.

A diagnosis beside the benchmark, not a cell: nothing in ``run.py`` reads
it. Without a CUDA device it exits with 2."""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel,
    cuLaunchKernelEx, ...), whose correlation id is the device's own."""
    return name.startswith("cu")


def _innermost_span(spans, starts, t):
    """The latest-starting program span, on any thread, that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for start, end, name in (spans[j] for j in range(i, max(i - 4096, -1), -1)):
        if end >= t:
            return name
    return "-"


def span_device_seconds(prof, annotations=()) -> dict:
    """Each program span's device seconds in a finished profile: an
    operation on the device belongs to the innermost span, on any thread,
    that holds the host call that launched it: the runtime call of the same
    correlation id, or else the host operation it is linked to. So a kernel
    that autograd launches from its own thread belongs to the span that
    waits for the backward. The device's copies of ``annotations`` (user
    ranges) are not operations and count nowhere."""
    import torch

    events = list(prof.profiler.kineto_results.events())
    runtime, ops, spans = {}, {}, []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            name, start = e.name(), e.start_ns()
            (runtime if _is_runtime(name) else ops)[e.correlation_id()] = start
            if name.startswith("sg."):
                spans.append((start, start + e.duration_ns(), name))
    spans.sort()
    starts = [s[0] for s in spans]
    out = collections.defaultdict(float)
    for e in events:
        if (e.device_type() != torch.autograd.DeviceType.CUDA or e.name() in annotations
                or e.name().startswith("sg.")):
            continue
        t = runtime.get(e.correlation_id(), ops.get(e.linked_correlation_id()))
        out["-" if t is None else _innermost_span(spans, starts, t)] += e.duration_ns() * 1e-9
    return dict(out)


def gaps_by_program_span(prof, benchmark_spans) -> dict:
    """Idle seconds of the window by ``benchmark span/program span/host
    event`` at each gap's midpoint, as ``profiling.read`` finds the gaps."""
    import torch

    from benchmark import profiling

    annotations = {profiling.WINDOW} | set(benchmark_spans)
    device, host, outer, program = [], [], [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in annotations and not name.startswith("sg."):
                device.append((start, end))
        elif name == profiling.WINDOW:
            window = (start, end)
        else:
            host.append((start, end, name))
            if name in benchmark_spans:
                outer.append((start, end, name))
            if name.startswith("sg."):
                program.append((start, end, name))
    lo, hi = window
    busy = profiling._merge([(max(s, lo), min(t, hi)) for s, t in device if min(t, hi) > max(s, lo)])
    for events in (host, outer, program):
        events.sort()
    starts = {id(h): [e[0] for e in h] for h in (host, outer, program)}
    gaps = collections.defaultdict(float)
    cursor = lo
    for start, end in busy + [(hi, hi)]:
        if start > cursor:
            mid = (cursor + start) // 2
            label = "/".join((profiling._label(outer, starts[id(outer)], mid) if outer else "-",
                              _innermost_span(program, starts[id(program)], mid),
                              profiling._label(host, starts[id(host)], mid)))
            gaps[label] += (start - cursor) * 1e-9
        cursor = max(cursor, end)
    return dict(gaps)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness, profiling, readers
    from shapegan_tpu_torch import tracing

    if not torch.cuda.is_available():
        print("attribute.py: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    drv = harness.driver(cell.traffic)
    state = drv.setup(cell, args.seed, device)
    spans = harness.Spans(device, annotate=True)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(profiling.WINDOW):
            out = drv.window(state, args.seconds, spans)
    drv.release(state)
    reading = profiling.read(prof, spans=set(spans.pairs))
    attributed = span_device_seconds(prof, {profiling.WINDOW} | set(spans.pairs))
    gaps = gaps_by_program_span(prof, set(spans.pairs))
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "workload": cell.name, "device": torch.cuda.get_device_name(device),
        "units": out["units"], "window_s": reading.window_s, "busy_s": reading.busy_s,
        "kernel_spans_s": sum(v for k, v in attributed.items() if k.startswith("sg.kernel.")),
        "port_kernels_s": reading.device_seconds(readers.PORT_KERNELS),
        "span_device_s": dict(sorted(attributed.items(), key=lambda kv: -kv[1])),
        "d_backward_device_ms": 1e3 * attributed.get("sg.d_step.backward", 0.0)
        / max(1, tracing.profiled()["spans"].get("sg.d_step", (0, 0))[0]),
        "span_host_s": tracing.profiled()["spans"], "counts": tracing.profiled()["counts"],
        "idle_s": reading.window_s - reading.busy_s,
        "idle_outside_program_s": sum(v for k, v in gaps.items() if k.split("/")[1] == "-"),
        "idle_gaps": [[k, v] for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A traced run reads the program's own spans and counters: the profiling
reader leaves the program's operator ranges out of the device's busy time
and names them in the idle gaps' labels; the readers of the program's
spans and counters read ``shapegan_tpu_torch.tracing``'s record of the
window, and return None for a program without it; and a traced run of
each cell on the CPU reports them."""

import sys
import time
import types

import pytest
import torch

from benchmark import counts, harness, profiling
from benchmark.tests import tiny

import attribute  # benchmark/attribute.py, on the path through conftest
import run  # benchmark/run.py, on the path through conftest

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NEW = {"hpgan64.train": ("d_step_dispatch_ms.train", "g_step_dispatch_ms.train",
                         "optimizer_dispatch_ms.train"),
       "hpgan64.generate": ("operands_dispatch_ms.generate",),
       "deepsdf_chair.raymarch": ("trace_useful_share.raymarch", "host_waits_per_frame.raymarch")}


def _event(name, start, end, device=CPU, corr=0, linked=0):
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                                 duration_ns=lambda: end - start, device_type=lambda: device,
                                 correlation_id=lambda: corr, linked_correlation_id=lambda: linked)


def _profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_program_ranges_are_host_events_that_label_gaps():
    """A D step whose backward waits on the host between two kernels: the
    program's ranges (host events) add nothing to the kernels or busy time,
    and the gap inside the backward, where no aten operation runs, is
    labelled with the benchmark's span and the program's innermost one."""
    events = [
        _event(profiling.WINDOW, 0, 1000),
        _event("d_step", 0, 1000), _event("d_step", 0, 1000, CUDA),
        _event("sg.d_step", 10, 990),
        _event("sg.d_step.backward", 100, 900),
        _event("aten::mm", 110, 150), _event("sm90_gemm", 150, 400, CUDA),
        _event("aten::mm", 600, 640), _event("sm90_gemm", 640, 1000, CUDA),
    ]
    reading = profiling.read(_profile(events), spans={"d_step"})
    assert reading.kernels == pytest.approx({"sm90_gemm": 610e-9})
    assert reading.busy_s == pytest.approx(610e-9)
    assert reading.gaps == pytest.approx({"d_step/sg.d_step": 150e-9,
                                          "d_step/sg.d_step.backward": 240e-9})
    # attribute.py's labels name the program span even inside an aten op.
    events[5] = _event("aten::mm", 110, 200)
    assert attribute.gaps_by_program_span(_profile(events), {"d_step"}) == pytest.approx(
        {"d_step/sg.d_step/sg.d_step": 150e-9,
         "d_step/sg.d_step.backward/sg.d_step.backward": 240e-9})


def test_device_time_goes_to_the_span_that_launched_it():
    """A kernel launched through ctypes inside sg.kernel.grid_forward (its
    runtime call shares the kernel's correlation id), a kernel that
    autograd's thread launches while the main thread waits inside
    sg.d_step.backward (linked to an aten operation on that thread), and
    one launched outside every program span; a device copy of a user range
    counts nowhere. Ids of runtime calls and of operations are apart."""
    events = [
        _event("sg.generate", 0, 100), _event("sg.kernel.grid_forward", 50, 90),
        _event("cudaLaunchKernelExC", 60, 70, corr=7),
        _event("sdf_grid_kernel", 100, 600, CUDA, corr=7, linked=1),
        _event("aten::mm", 20, 40, corr=7), _event("gemm", 40, 50, CUDA, corr=9, linked=7),
        _event("sg.d_step.backward", 1000, 2000),
        _event("aten::convolution_backward", 1100, 1200, corr=30),   # autograd's thread
        _event("cudaLaunchKernel", 1150, 1160, corr=31),
        _event("dgrad", 1200, 1500, CUDA, corr=31, linked=30),
        _event("aten::add", 2100, 2110, corr=40), _event("add", 2110, 2120, CUDA, corr=41, linked=40),
        _event("d_step", 1000, 2000, CUDA),
    ]
    got = attribute.span_device_seconds(_profile(events), {"d_step"})
    assert got == pytest.approx({"sg.kernel.grid_forward": 500e-9, "sg.generate": 10e-9,
                                 "sg.d_step.backward": 300e-9, "-": 10e-9})


def _recorded(monkeypatch, spans=(), counters=()):
    from shapegan_tpu_torch import tracing

    monkeypatch.setattr(tracing, "profiled", lambda: {"spans": dict(spans), "counts": dict(counters)})


def _reading(cell, counts_=None, work=None):
    return harness.Reading(cell, 20.0, counts_ or {}, {}, work or {}, 0.0, None)


def test_readers_of_the_program_record(monkeypatch):
    _recorded(monkeypatch,
              spans={"sg.d_step": (4, 0.040), "sg.g_step": (1, 0.020),
                     "sg.g_step.optimizer": (1, 0.002), "sg.d_step.optimizer": (4, 0.006),
                     "sg.generate.operands": (10, 0.005)},
              counters={"render.lane_steps": 4_000_000, "render.host_waits": 30})
    read = {name: harness.metric_reader(name).read for names in NEW.values() for name in names}
    train = _reading("hpgan64.train", {"batches": 4})
    assert read["d_step_dispatch_ms.train"](train) == pytest.approx(10.0)
    assert read["g_step_dispatch_ms.train"](train) == pytest.approx(20.0)
    assert read["optimizer_dispatch_ms.train"](train) == pytest.approx(2.0)
    generate = _reading("hpgan64.generate", {"requests": 10})
    assert read["operands_dispatch_ms.generate"](generate) == pytest.approx(0.5)
    width = harness.cell("deepsdf_chair.raymarch").config["width"]
    frame = _reading("deepsdf_chair.raymarch", {"frames": 3},
                     {"trace": (counts.trace_flops(3_000_000, width), 0)})
    assert read["trace_useful_share.raymarch"](frame) == pytest.approx(75.0)
    assert read["host_waits_per_frame.raymarch"](frame) == pytest.approx(10.0)


def test_readers_find_nothing_in_an_older_program(monkeypatch):
    import shapegan_tpu_torch

    monkeypatch.delattr(shapegan_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "shapegan_tpu_torch.tracing", None)   # import fails
    for cell, names in NEW.items():
        reading = _reading(cell, {"batches": 4, "requests": 10, "frames": 3},
                           {"trace": (1e12, 0)})
        for name in names:
            assert harness.metric_reader(name).read(reading) is None, name


@pytest.mark.parametrize("workload", list(NEW))
def test_traced_run_on_the_cpu_reports_the_program_metrics(workload):
    from shapegan_tpu_torch import tracing

    cell = tiny.cell(workload)
    cell.config["g_every"] = 1   # a G step in every batch of the short window
    tracing.reset()
    result = run.run(cell, 2**31 + 45, 0.3, True, torch.device("cpu"), time.perf_counter())
    for name in NEW[workload]:
        assert result["metrics"].get(name, {}).get("value", 0) > 0, (name, tracing.profiled())

"""The port's spans and counters (shapegan_tpu_torch.tracing) on the CPU:
off, a span costs a flag check and opens no profiler range; under
torch.profiler the trainer's step phases, generation's operands and the
kernels' wrappers are operator ranges, nested as the steps run them; the
renderer counts the lane-steps it launches and the host tests that wait
for the device. The trainers' own step timers wait for nothing."""

import numpy as np
import pytest
import torch

from shapegan_tpu_torch import tracing
from shapegan_tpu_torch.examples import octahedron_params
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import point_gen_kernels as PG
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.render import raymarching as rm
from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer
from shapegan_tpu_torch.train.common import RollingHistory, StepProfiler
from shapegan_tpu_torch.train.hybrid_gan import generate_volumes_inference

WRAPPERS = {"grid_forward": K.grid_forward_cuda, "points_forward": K.points_forward_cuda,
            "grid_backward": K.grid_backward_cuda, "grid_backward_rows": K.grid_backward_rows_cuda,
            "grid_backward_passes": K.grid_backward_passes_cuda,
            "grid_forward_stash": K.grid_forward_stash_cuda,
            "grid_backward_stash": K.grid_backward_stash_cuda, "trace_steps": K.trace_steps_cuda,
            "rowwise_forward": K.rowwise_forward_cuda, "rowwise_backward": K.rowwise_backward_cuda,
            "generate": PG.generate_cuda}
# Each span and the spans that run inside it, in order.
NESTED = {
    "sg.g_step": ("sg.g_step.generate", "sg.g_step.critic", "sg.g_step.backward",
                  "sg.g_step.optimizer"),
    "sg.d_step": ("sg.d_step.fakes", "sg.d_step.critic", "sg.d_step.penalty", "sg.d_step.backward",
                  "sg.d_step.optimizer"),
    "sg.d_step.fakes": ("sg.generate",),
    "sg.generate": ("sg.generate.operands",),
}


def _program_events(prof):
    """(start, end, name, user annotation) of each program span, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name(), e.is_user_annotation())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("sg."))


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_off_opens_no_range(monkeypatch):
    """With no profiler recording, neither a span nor a traced kernel
    wrapper enters a profiler range; every span is one shared object."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: entered.append(a))
    monkeypatch.setattr(tracing, "_Range", lambda *a: entered.append(a))
    assert not torch._C._autograd._profiler_enabled()
    with tracing.span("sg.a"):
        with tracing.span("sg.b"):
            pass
    assert tracing.span("sg.a") is tracing.span("sg.b")
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        K.grid_forward_cuda(*(torch.zeros(1),) * 7)
    assert entered == []


def test_kernel_wrappers_are_spans_and_keep_their_counts():
    """Each hand kernel's wrapper is the span sg.kernel.<name>, covering its
    checks (a CPU tensor fails them here), and keeps its launch_count."""
    for name, wrapper in WRAPPERS.items():
        assert wrapper.__wrapped__.__name__ == f"{name}_cuda"
        assert isinstance(wrapper.launch_count, int)
    before = K.grid_forward_cuda.launch_count
    with _cpu_profile() as prof:
        with pytest.raises(ValueError):
            K.grid_forward_cuda(*(torch.zeros(1),) * 7)
    assert [e[2] for e in _program_events(prof)] == ["sg.kernel.grid_forward"]
    assert K.grid_forward_cuda.launch_count == before


def test_step_phases_nest_under_the_profiler():
    """One G step and one D step of make_steps at 8^3: every phase span
    lies inside its step's span, in the order the step runs them, as an
    operator range (a user range would also be drawn on the device's
    timeline); profiled() counts one call of each."""
    torch.manual_seed(0)
    net, critic = trainer.create_models(seed=3)
    g_step, d_step = trainer.make_steps(net, critic, RMSprop(net.param_dict(), 1e-4),
                                        RMSprop(dict(critic.named_parameters()), 1e-4), 0)
    z, batch = torch.randn(2, 128), torch.rand(2, 8, 8, 8) * 0.2 - 0.1
    tracing.reset()
    with _cpu_profile() as prof:
        g_step(z, 1.0)
        d_step(batch, z, torch.rand(2, 1, 1, 1), 1.0)
    events = _program_events(prof)
    assert not any(user for *_, user in events)
    by_name = {}
    for start, end, name, _ in events:
        by_name.setdefault(name, []).append((start, end))
    for parent, children in NESTED.items():
        (lo, hi), = by_name[parent]
        starts = []
        for child in children:
            (start, end), = by_name[child]
            assert lo <= start <= end <= hi, (parent, child)
            starts.append(start)
        assert starts == sorted(starts), parent
    seen = tracing.profiled()["spans"]
    for name in set(NESTED) | {c for cs in NESTED.values() for c in cs}:
        assert seen[name][0] == 1 and seen[name][1] > 0, name


def test_generation_opens_the_operands_span():
    net = SDFNet(sdf_mlp.init(torch.Generator().manual_seed(0)))
    grid = voxel_coordinates(8)
    tracing.reset()
    with _cpu_profile() as prof:
        volumes = generate_volumes_inference(net, grid, torch.randn(2, 128), 8)
        generate_volumes_inference(net, grid, torch.randn(1, 128), 8)   # the points kernel's path
    assert volumes.shape == (2, 8, 8, 8)
    names = [e[2] for e in _program_events(prof)]
    assert names == ["sg.generate", "sg.generate.operands"] * 2
    assert tracing.profiled()["spans"]["sg.generate.operands"][0] == 2
    generate_volumes_inference(net, grid, torch.randn(2, 128), 8)   # no profiler: not recorded
    assert tracing.profiled()["spans"]["sg.generate.operands"][0] == 2


def test_render_counts_lane_steps_and_host_waits(monkeypatch):
    """A 48^2-lane frame (the staged, compacted trace: fused launches while
    2,048 lanes or more are live, points-kernel steps after): lane_steps
    adds N x k a fused launch and N a step; host_waits one a host test
    (any-active, the compaction's count) and one for the frame's copy."""
    launched, tests = {"fused": 0, "step": 0}, [0]

    def recording(fn, kind, lanes):
        def call(*args, **kwargs):
            launched[kind] += lanes(args, kwargs)
            return fn(*args, **kwargs)
        return call

    def counting(fn):
        def call(*args, **kwargs):
            tests[0] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(K, "trace_steps",
                        recording(K.trace_steps, "fused", lambda a, kw: a[0].shape[0] * kw["k"]))
    monkeypatch.setattr(K, "points_forward",
                        recording(K.points_forward, "step", lambda a, kw: a[0].shape[0]))
    monkeypatch.setattr(rm, "_any_active", counting(rm._any_active))
    monkeypatch.setattr(torch, "nonzero", counting(torch.nonzero))
    net = SDFNet(sdf_mlp.params_from_jax(octahedron_params()))
    code = np.random.default_rng(0).normal(size=128).astype(np.float32)
    before = tracing.counters()
    frame = rm.render_image(net, code, resolution=24, ssaa=2)
    after = tracing.counters()
    moved = {k: after[k] - before.get(k, 0) for k in ("render.lane_steps", "render.host_waits")}
    assert frame.shape == (24, 24, 3)
    assert launched["fused"] >= 48 * 48 and launched["step"] > 0 and tests[0] > 1
    assert moved == {"render.lane_steps": launched["fused"] + launched["step"],
                     "render.host_waits": tests[0] + 1}


def test_rolling_history_reads_the_device_at_mean():
    history = RollingHistory(3)
    for value in (torch.tensor(1.0), 2.0, torch.tensor([3.5]),
                  torch.tensor(4.0, requires_grad=True)):
        history.append(value)
    assert len(history) == 3
    assert all(not torch.is_tensor(v) or not v.requires_grad for v in history._values)
    assert history.mean == pytest.approx((2.0 + 3.5 + 4.0) / 3)
    assert np.isnan(RollingHistory().mean)


def test_step_profiler_waits_only_when_read(monkeypatch):
    """On CUDA a step records an event pair and waits for nothing; reading
    ``times`` waits for the pairs and resolves them (a stand-in event class
    here). On the CPU, the host clock."""
    log = []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing
            self.at = len(log)

        def record(self, stream):
            log.append("record")

        def synchronize(self):
            log.append("wait")

        def elapsed_time(self, end):
            return float(end.at - self.at)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: log.append("sync"))
    profiler = StepProfiler(torch.device("cuda", 0))
    for _ in range(3):
        with profiler:
            pass
    assert log == ["record"] * 6
    assert profiler.times == [1e-3] * 3 and log.count("wait") == 3
    assert profiler.mean_step_time == pytest.approx(1e-3) and log.count("wait") == 3
    cpu = StepProfiler("cpu")
    with cpu:
        pass
    assert len(cpu.times) == 1 and 0 <= cpu.mean_step_time < 1


def test_counts_from_many_threads_lose_nothing():
    """count() is a read-modify-write under a lock: threads that outnumber
    the cores, switching every microsecond, add up exactly."""
    import sys
    import threading

    threads, adds = 16, 2000
    before = tracing.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count("test.threads") for _ in range(adds)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert tracing.counters()["test.threads"] - before == threads * adds

"""The progressive trainer's steps as replays of CUDA graphs, on the CPU:
RMSprop keeps its moments in place (a graph reads and writes the same
tensors on every replay) with the rule's values bitwise; ``make_steps`` on
the CPU stays eager and captures nothing; and the graphed dispatch
(``_Replayed``) with a CPU stand-in for the capture: the first call of a
key eager, the second a capture and its replay, later ones replays, the
outputs the caller's own, a new key for a new shape, TF32 flag or grid
VJP, and each replay's launches added to the kernels' counts. The card's
own test of graphed against eager steps is test_torch_step_graphs_cuda.py."""

import pytest
import torch

from shapegan_tpu_torch import tracing
from shapegan_tpu_torch.ops import _build
from shapegan_tpu_torch.optim import DECAY, EPS, RMSprop
from shapegan_tpu_torch.train import hybrid_gan
from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer

CAPTURES, REPLAYS = "train.graph_captures", "train.graph_replays"


def _old_rmsprop_step(params, nu, grads, lr):
    """RMSprop's rule as it was written before its moments stayed in place:
    a new ``nu`` tensor each step."""
    for key, param in params.items():
        g = grads[key]
        nu[key] = (1.0 - DECAY) * (g * g) + DECAY * nu[key]
        param.add_((torch.rsqrt(nu[key] + EPS) * g) * -lr)


def _counter(name):
    return tracing.counters().get(name, 0)


def test_rmsprop_updates_its_moments_in_place_bitwise():
    gen = torch.Generator().manual_seed(0)
    shapes = {"w": (7, 5), "b": (5,), "s": ()}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    ref_params = {k: v.clone() for k, v in params.items()}
    ref_nu = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = RMSprop(params, 3e-4)
    moments = dict(opt.nu)
    for _ in range(4):
        grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        opt.step(grads)
        _old_rmsprop_step(ref_params, ref_nu, grads, 3e-4)
        for key in shapes:
            assert opt.nu[key] is moments[key], key
            assert torch.equal(opt.nu[key], ref_nu[key]), key
            assert torch.equal(params[key], ref_params[key]), key


def test_rmsprop_load_state_copies_in_place():
    params = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    opt = RMSprop(params, 1e-4)
    moments = dict(opt.nu)
    state = {"nu": {"w": torch.full((3, 2), 0.25), "b": torch.arange(2.0)}}
    opt.load_state(state)
    for key in params:
        assert opt.nu[key] is moments[key], key
        assert torch.equal(opt.nu[key], state["nu"][key]), key
    state["nu"]["b"].fill_(7.0)  # the optimizer holds copies, not the caller's tensors
    assert torch.equal(opt.nu["b"], torch.arange(2.0))


def test_make_steps_on_the_cpu_stays_eager():
    """Steps on the CPU run their phases eagerly, call after call, and
    neither capture nor replay a graph."""
    torch.manual_seed(0)
    net, critic = trainer.create_models(seed=3)
    g_step, d_step = trainer.make_steps(net, critic, RMSprop(net.param_dict(), 1e-4),
                                        RMSprop(dict(critic.named_parameters()), 1e-4), 0)
    z, batch = torch.randn(2, 128), torch.rand(2, 8, 8, 8) * 0.2 - 0.1
    captures, replays = _counter(CAPTURES), _counter(REPLAYS)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            g_step(z, 1.0)
            d_step(batch, z, torch.rand(2, 1, 1, 1), 1.0)
    seen = tracing.profiled()["spans"]
    assert seen["sg.g_step.optimizer"][0] == 3 and seen["sg.d_step.penalty"][0] == 3
    assert "sg.g_step.replay" not in seen and "sg.d_step.replay" not in seen
    assert (_counter(CAPTURES), _counter(REPLAYS)) == (captures, replays)


def _kernel():
    """A stand-in for a hand kernel's wrapper."""


_kernel.launch_count = 0


class _CpuGraph:
    """A CPU stand-in for a captured CUDA graph: a replay runs the body
    again on the static inputs, without counting launches (a replay makes
    no wrapper call), and writes the static outputs in place."""

    def __init__(self, body, inputs, monkeypatch):
        self.body, self.inputs, self.monkeypatch = body, inputs, monkeypatch

    def replay(self):
        with self.monkeypatch.context() as m:
            m.setattr(_build, "count_launch", lambda wrapper: None)
            fresh = self.body(*self.inputs)
        for key, value in fresh.items():
            self.outputs[key].copy_(value)


@pytest.fixture
def cpu_capture(monkeypatch):
    def record(body, inputs):
        graph = _CpuGraph(body, inputs, monkeypatch)
        graph.outputs = body(*inputs)
        return graph, graph.outputs

    monkeypatch.setattr(trainer, "_record_graph", record)


def _body(calls):
    def body(x, y):
        calls.append(1)
        _build.count_launch(_kernel)
        return {"sum": x + y, "scale": (x * 2.0).sum()}
    return body


def test_graphed_dispatch_eager_then_capture_then_replays(cpu_capture):
    calls = []
    step = trainer._Replayed("sg.test_step", _body(calls))
    captures, replays, launches = _counter(CAPTURES), _counter(REPLAYS), _kernel.launch_count
    gen = torch.Generator().manual_seed(1)
    kept = []
    for i in range(5):
        x, y = torch.randn(4, 3, generator=gen), torch.randn(4, 3, generator=gen)
        out = step(x, y)
        assert torch.equal(out["sum"], x + y) and torch.equal(out["scale"], (x * 2.0).sum())
        kept.append((out, {k: v.clone() for k, v in out.items()}))
        # Call 1 eager, call 2 a capture and its replay, then replays.
        assert _counter(CAPTURES) - captures == (1 if i >= 1 else 0)
        assert _counter(REPLAYS) - replays == max(i, 0)
        assert _kernel.launch_count - launches == i + 1
    assert len(calls) == 6  # the eager call, the capture, four stand-in replays
    graph, = step._graphs.values()
    for out, copy in kept:  # outputs are clones, untouched by later replays
        assert all(v is not s for v, s in zip(out.values(), graph.outputs.values()))
        assert all(torch.equal(out[k], copy[k]) for k in copy)


def test_graphed_dispatch_keys_on_shape_tf32_and_grid_vjp(cpu_capture, monkeypatch):
    step = trainer._Replayed("sg.test_step", _body([]))
    captures = _counter(CAPTURES)
    x = torch.ones(4, 3)
    step(x, x)
    step(x, x)
    assert _counter(CAPTURES) - captures == 1
    half = torch.ones(2, 3)
    step(half, half)  # a new shape: eager first
    assert _counter(CAPTURES) - captures == 1
    assert torch.equal(step(half, half)["sum"], half * 2)  # then its own capture
    assert _counter(CAPTURES) - captures == 2
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not torch.backends.cudnn.allow_tf32)
    step(x, x)
    step(x, x)
    assert _counter(CAPTURES) - captures == 3 and len(step._graphs) == 3
    monkeypatch.setattr(hybrid_gan, "_GRID_STASH", (1, 2, 3, 4, 5, 6))  # another grid VJP
    step(x, x)
    step(x, x)
    assert _counter(CAPTURES) - captures == 4 and len(step._graphs) == 4


"""The voxel GAN trainer's spans and counter (shapegan_tpu_torch.tracing) on
the CPU: under torch.profiler one G step and one D step of
``train.gan.make_steps`` open each phase span inside its step's span, as
many times as the step runs that phase, and Adam counts the tensors it
updates (the generator's 14 once, the discriminator's 8 twice); with no
profiler the spans change nothing, bitwise."""

import pytest
import torch

from shapegan_tpu_torch import tracing
from shapegan_tpu_torch.train import gan as trainer

BATCH = 4
# Each span, the spans that run inside it in order, and their calls.
NESTED = {
    "sg.g_step": ("sg.g_step.generate", "sg.g_step.critic", "sg.g_step.backward",
                  "sg.g_step.optimizer"),
    "sg.d_step": ("sg.d_step.fakes", "sg.d_step.critic", "sg.d_step.optimizer",
                  "sg.d_step.critic", "sg.d_step.optimizer"),
}
CALLS = {"sg.g_step": 1, "sg.g_step.generate": 1, "sg.g_step.critic": 1,
         "sg.g_step.backward": 1, "sg.g_step.optimizer": 1, "sg.d_step": 1,
         "sg.d_step.fakes": 1, "sg.d_step.critic": 2, "sg.d_step.optimizer": 2}
G_TENSORS, D_TENSORS = 14, 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under pytest-xdist the workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    gen = torch.Generator().manual_seed(5)
    z_g = torch.randn((BATCH, 128), generator=gen)
    z_d = torch.randn((BATCH, 128), generator=gen)
    real = torch.rand((BATCH, 32, 32, 32), generator=gen) * 2.0 - 1.0
    return z_g, z_d, real


def _batch(profile: bool):
    """One G step and one D step from fresh states of seed 3: the outputs,
    every parameter, buffer and Adam moment after them, and the profiler."""
    g_net, d_net, g_opt, d_opt = trainer.create_states(seed=3)
    g_step, d_step = trainer.make_steps(g_net, d_net, g_opt, d_opt)
    z_g, z_d, real = _inputs()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    if profile:
        prof.__enter__()
    try:
        fake = g_step(z_g)
        metrics = d_step(real, z_d)
    finally:
        if profile:
            prof.__exit__(None, None, None)
    state = {"fake": fake, **{f"metric.{k}": v for k, v in metrics.items()}}
    for tag, net, opt in (("g", g_net, g_opt), ("d", d_net, d_opt)):
        state.update({f"{tag}.{k}": v for k, v in net.state_dict().items()})
        state.update({f"{tag}.mu.{k}": v for k, v in opt.mu.items()})
        state.update({f"{tag}.nu.{k}": v for k, v in opt.nu.items()})
    return state, prof


def test_spans_nest_and_count_under_the_profiler():
    tracing.reset()
    before = tracing.counters().get("optim.adam_tensor_updates", 0)
    _, prof = _batch(profile=True)
    events = sorted((e.start_ns(), e.end_ns(), e.name(), e.is_user_annotation())
                    for e in prof.profiler.kineto_results.events() if e.name().startswith("sg."))
    assert not any(user for *_, user in events), "operator ranges, not user annotations"
    by_name = {}
    for start, end, name, _ in events:
        by_name.setdefault(name, []).append((start, end))
    for parent, children in NESTED.items():
        (lo, hi), = by_name[parent]
        inside = [(s, n) for s, e, n, _ in events if lo <= s and e <= hi and n in children]
        assert [n for _, n in sorted(inside)] == list(children), parent
    seen = tracing.profiled()
    assert {k: seen["spans"][k][0] for k in CALLS} == CALLS
    assert all(seen["spans"][k][1] > 0 for k in CALLS)
    updates = G_TENSORS + 2 * D_TENSORS
    assert seen["counts"]["optim.adam_tensor_updates"] == updates
    assert tracing.counters()["optim.adam_tensor_updates"] - before == updates


def test_steps_without_a_profiler_match_traced_steps_bitwise():
    assert not torch._C._autograd._profiler_enabled()
    plain, _ = _batch(profile=False)
    traced, _ = _batch(profile=True)
    assert plain.keys() == traced.keys() and len(plain) > 40
    for key, value in plain.items():
        assert torch.equal(value, traced[key]), key


def test_adam_counts_its_tensors_with_no_profiler():
    """The counter moves whether or not a profiler records; what a profiler
    saw does not."""
    from shapegan_tpu_torch.optim import Adam

    params = {"a": torch.zeros(3), "b": torch.zeros(2, 2), "c": torch.zeros(())}
    opt = Adam(params, 1e-3)
    tracing.reset()
    before = tracing.counters().get("optim.adam_tensor_updates", 0)
    opt.step({k: torch.ones_like(v) for k, v in params.items()})
    opt.step({k: torch.ones_like(v) for k, v in params.items()})
    assert tracing.counters()["optim.adam_tensor_updates"] - before == 6
    assert "optim.adam_tensor_updates" not in tracing.profiled()["counts"]

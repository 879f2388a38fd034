"""The progressive trainer's steps as replays of CUDA graphs against the same
steps called eagerly, on the card: from the same weights and inputs,
``make_steps`` (the first call of a shape eager, the second a capture, then
replays) and ``generator_grads`` / ``critic_grads`` with ``RMSprop`` called
directly give bitwise the same fakes, metrics, parameters and moments after
every batch, at a fixed fade and at one that changes every batch; each step
captures once; a returned tensor stays as it was through later calls; the
hand kernels' launch counts grow as the eager run's; a half batch is eager
first and then gets its own graph. Marked ``gpu``: without CUDA each test
skips. On a machine with a GPU:

    python -m pytest tests/test_torch_step_graphs_cuda.py -q -m gpu
"""

import pytest
import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, tracing
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer
from shapegan_tpu_torch.train.hybrid_gan import generate_volumes_inference

pytestmark = pytest.mark.gpu

ITERATION = 2          # 32^3: the fade blends the entry conv with the raw input
BATCH = 4
BATCHES = 11           # G steps at batches 0, 5 and 10: eager, capture, replay
G_EVERY = 5
LR = 1e-4
CAPTURES, REPLAYS = "train.graph_captures", "train.graph_replays"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # Deterministic cuDNN algorithms on both sides, so that two eager runs
    # would agree bitwise too; the graphs keep whatever algorithms they
    # were captured with.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = deterministic


def _side(device):
    net, critic = trainer.create_models(seed=7, device=device)
    return (net, critic, RMSprop(net.param_dict(), LR),
            RMSprop(dict(critic.named_parameters()), LR))


def _inputs(device):
    gen = torch.Generator(device=device).manual_seed(2024)
    res = trainer.RESOLUTIONS[ITERATION]
    feed = []
    for i in range(BATCHES):
        item = {}
        if i % G_EVERY == 0:
            item["z_g"] = torch.randn((BATCH, LATENT_CODE_SIZE), generator=gen, device=device)
        item["real"] = torch.rand((BATCH, res, res, res), generator=gen, device=device) * 0.2 - 0.1
        item["z"] = torch.randn((BATCH, LATENT_CODE_SIZE), generator=gen, device=device)
        item["alpha"] = torch.rand((BATCH, 1, 1, 1), generator=gen, device=device)
        feed.append(item)
    return feed


def _launches():
    return (K.grid_forward_cuda.launch_count, K.grid_backward_cuda.launch_count)


def _state_equal(a, b):
    net_a, critic_a, g_opt_a, d_opt_a = a
    net_b, critic_b, g_opt_b, d_opt_b = b
    for x, y in ((net_a.param_dict(), net_b.param_dict()),
                 (dict(critic_a.named_parameters()), dict(critic_b.named_parameters())),
                 (g_opt_a.nu, g_opt_b.nu), (d_opt_a.nu, d_opt_b.nu)):
        for key in y:
            assert torch.equal(x[key], y[key]), key


@pytest.mark.parametrize("fading", [False, True])
def test_graphed_steps_equal_eager_steps_bitwise(cuda, fading):
    graphed, eager = _side(cuda), _side(cuda)
    net, critic, g_opt, d_opt = eager
    g_step, d_step = trainer.make_steps(*graphed, ITERATION)
    res = trainer.RESOLUTIONS[ITERATION]
    grid = voxel_coordinates(res, device=cuda)

    def eager_g(z, fade):
        grads, fake = trainer.generator_grads(net, critic, grid, z, ITERATION, fade)
        g_opt.step(grads)
        return fake

    def eager_d(batch, z, alpha, fade):
        fake = generate_volumes_inference(net, grid, z, res)
        grads, metrics = trainer.critic_grads(critic, fake, batch, alpha, ITERATION, fade)
        d_opt.step(grads)
        return metrics

    captures, replays = tracing.counters().get(CAPTURES, 0), tracing.counters().get(REPLAYS, 0)
    kept = []   # (a returned tensor, its copy when returned)
    g_calls = d_calls = 0
    for i, item in enumerate(_inputs(cuda)):
        fade = 0.05 + 0.09 * i if fading else 1.0
        if "z_g" in item:
            before = _launches()
            fake = g_step(item["z_g"], fade)
            graphed_launches = tuple(b - a for a, b in zip(before, _launches()))
            before = _launches()
            ref = eager_g(item["z_g"], fade)
            assert graphed_launches == tuple(b - a for a, b in zip(before, _launches())) == (1, 1)
            assert torch.equal(fake, ref), i
            kept.append((fake, fake.clone()))
            g_calls += 1
        before = _launches()
        metrics = d_step(item["real"], item["z"], item["alpha"], fade)
        graphed_launches = tuple(b - a for a, b in zip(before, _launches()))
        before = _launches()
        ref = eager_d(item["real"], item["z"], item["alpha"], fade)
        assert graphed_launches == tuple(b - a for a, b in zip(before, _launches())) == (1, 0)
        assert metrics.keys() == ref.keys()
        for key in ref:
            assert torch.equal(metrics[key], ref[key]), (i, key)
            kept.append((metrics[key], metrics[key].clone()))
        d_calls += 1
        _state_equal(graphed, eager)
        for tensor, copy in kept:
            assert torch.equal(tensor, copy), i
    counters = tracing.counters()
    assert counters.get(CAPTURES, 0) - captures == 2
    assert counters.get(REPLAYS, 0) - replays == (g_calls - 1) + (d_calls - 1)

    # A half batch is a new key: eager first, then its own capture, then replays.
    item = _inputs(cuda)[1]
    half = {k: item[k][:BATCH // 2] for k in ("real", "z", "alpha")}
    for call in range(3):
        metrics = d_step(half["real"], half["z"], half["alpha"], 1.0)
        ref = eager_d(half["real"], half["z"], half["alpha"], 1.0)
        for key in ref:
            assert torch.equal(metrics[key], ref[key]), (call, key)
        _state_equal(graphed, eager)
        assert tracing.counters().get(CAPTURES, 0) - captures == (2 if call == 0 else 3)

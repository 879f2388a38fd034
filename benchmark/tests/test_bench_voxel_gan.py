"""The voxel GAN cell (``voxelgan32.train``) on the CPU at batch 4 with 8
shapes, every width kept: the plain reference follows
``train.gan.make_steps`` from the same weights, latents and volumes; each
planted fault turns ``correct`` false and a sound run is correct, by the
cell's own limits; a traced run reports the cell's per-layer metrics, and
their readers find nothing in a program without spans; the convolution
counts equal hand arithmetic; the yardstick imports nothing of the
program."""

import copy
import os
import statistics
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, voxel_counts
from benchmark.inputs import shapes
from benchmark.reference import voxel_gan

import calibrate  # benchmark/calibrate.py, on the path through conftest
import run  # benchmark/run.py, on the path through conftest

CELL = "voxelgan32.train"
BATCH, SHAPES = 4, 8
SEED = 2**31 + 26
# The biases before BatchNorm: their gradient is nought to rounding.
ROUNDING_LEAVES = {"convt0.bias", "convt1.bias", "convt2.bias"}
NEW_METRICS = ("g_step_ms.voxel_train", "d_step_ms.voxel_train", "d_step_dispatch_ms.voxel_train",
               "optimizer_dispatch_us_per_tensor.voxel_train", "mfu.voxel_train")


def _cell():
    c = copy.deepcopy(harness.cell(CELL))
    c.config.update({"batch_size": BATCH, "dataset_shapes": SHAPES})
    c.traffic["warm_batches"] = c.traffic["checked_batches"]
    return c


@pytest.fixture(scope="module")
def cfg():
    return _cell().config


def _median_gap(got, ref, keys):
    return statistics.median(float((got[k] - ref[k]).norm() / ref[k].norm()) for k in keys)


def test_reference_follows_the_programs_steps(cfg):
    """Three batches of make_steps against the reference from the same
    tensors, float32 on both sides (the CPU has no TF32). Tolerances:
    rounding of float32 sums (fakes, scores: 1e-5; the first G update's
    moments: 1e-4 of their norm); the D step sees fakes from the generator
    after an Adam step that moves every element by about its rate whatever
    the gradient, so elements whose gradient is near nought move on
    rounding alone and the first D moments differ by a few 1e-3 (2e-2);
    that grows over later batches (up to 3e-2 seen by the third: 0.1). The
    running variance is blind to those steps' biases (5e-4); the running
    mean carries the biases before BatchNorm, which such steps move by at
    most the rate, 1e-3, an update (1e-3)."""
    from shapegan_tpu_torch.models.gan import Discriminator, Generator
    from shapegan_tpu_torch.optim import Adam
    from shapegan_tpu_torch.train import gan as trainer

    gen = torch.Generator().manual_seed(SEED)
    g_init, d_init = voxel_gan.fresh_weights(cfg, gen, "cpu")
    clip = cfg["sdf_clipping"]
    volumes = shapes.make_volumes(3 * BATCH, 32, clip, gen, "cpu") / clip
    feed = [{"z_g": torch.randn((BATCH, 128), generator=gen),
             "z_d": torch.randn((BATCH, 128), generator=gen),
             "real": volumes[i * BATCH:(i + 1) * BATCH]} for i in range(3)]
    g_net, d_net = Generator(), Discriminator(True)
    g_net.load_state_dict(g_init)
    d_net.load_state_dict(d_init)
    g_opt = Adam(dict(g_net.named_parameters()), cfg["g_learning_rate"])
    d_opt = Adam(dict(d_net.named_parameters()), cfg["d_learning_rate"])
    g_step, d_step = trainer.make_steps(g_net, d_net, g_opt, d_opt)
    scores = []
    handle = d_net.register_forward_hook(lambda m, i, out: scores.append(out.detach()))
    for n, batch in enumerate(feed, 1):
        fake = g_step(batch["z_g"])
        g_scores = torch.cat(scores).sort().values
        scores.clear()
        d_step(batch["real"], batch["z_d"])
        d_scores = torch.cat(scores).sort().values
        scores.clear()
        ref = voxel_gan.follow(g_init, d_init, feed[:n], cfg)
        if n == 1:
            assert torch.allclose(fake, ref["fake"], rtol=0, atol=1e-5)
            assert torch.allclose(g_scores, ref["g_scores"], rtol=0, atol=1e-5)
            assert torch.allclose(d_scores, ref["d_scores"], rtol=0, atol=1e-5)
        g_tol, d_tol = (1e-4, 2e-2) if n == 1 else (0.1, 0.1)
        for opt, name, tol in ((g_opt, "g", g_tol), (d_opt, "d", d_tol)):
            state = ref[f"{name}_adam"]
            assert int(opt.count) == state["count"] == n * (1 if name == "g" else 2)
            keys = sorted(set(state["mu"]) - ROUNDING_LEAVES)
            for moment in ("mu", "nu"):
                gap = _median_gap(getattr(opt, moment), state[moment], keys)
                assert gap <= tol, (n, name, moment, gap)
        stats = dict(g_net.named_buffers())
        for key, value in ref["g_stats"].items():
            assert torch.allclose(stats[key], value, rtol=0,
                                  atol=5e-4 if key.endswith(".var") else 1e-3), (n, key)
    handle.remove()


@pytest.mark.parametrize("fault", sorted(harness.driver(harness.cell(CELL).traffic).FAULTS))
def test_fault_turns_correct_false(fault):
    row = calibrate.reading(_cell(), SEED, f"fault:{fault}", 0.0, torch.device("cpu"))
    assert row["correct"] is False, row["numbers"]


def test_set_up_records_the_d_steps_two_gradients_and_unwraps_adam():
    drv = harness.driver(harness.cell(CELL).traffic)
    state = drv.setup(_cell(), SEED, torch.device("cpu"))
    opt = state.program.d_opt
    assert "step" not in vars(opt) and "step" not in vars(state.program.g_opt)
    grads = state.record["d_grads"]
    assert len(grads) == 2 and set(grads[0]) == set(grads[1]) == set(opt.mu)
    # Adam's first moment after both updates, by optax's rule from the two
    # recorded gradients: the fakes', then the real batch's.
    for k, mu in state.record["d_mu"].items():
        first = 0.1 * grads[0][k] + 0.9 * torch.zeros_like(mu)
        assert torch.equal(mu, 0.1 * grads[1][k] + 0.9 * first), k


def test_sound_run_is_correct():
    result = run.run(_cell(), SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == set(harness.cell(CELL).limits["compare"])
    assert set(result["metrics"]) == {"setup_s", "train_samples_per_s"}


def test_traced_run_reports_the_cells_metrics():
    from shapegan_tpu_torch import tracing

    tracing.reset()
    result = run.run(_cell(), SEED + 1, 0.3, True, torch.device("cpu"), time.perf_counter())
    for name in NEW_METRICS:
        assert result["metrics"].get(name, {}).get("value", 0) > 0, (name, tracing.profiled())
    # No CUDA kernel on the CPU: the roofline finds nothing to read.
    assert "conv_roofline.voxel_train" not in result["metrics"]


def test_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    import shapegan_tpu_torch

    monkeypatch.delattr(shapegan_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "shapegan_tpu_torch.tracing", None)   # import fails
    reading = harness.Reading(CELL, 20.0, {"batches": 4}, {}, {}, 0.0, None)
    for name in ("d_step_dispatch_ms.voxel_train", "optimizer_dispatch_us_per_tensor.voxel_train",
                 "conv_roofline.voxel_train"):
        assert harness.metric_reader(name).read(reading) is None, name


def test_convolution_counts_by_hand(cfg):
    k3 = 4 ** 3
    g_fwd = (2 * 1 * 128 * 256 * k3          # convt0: 1^3 x 128 -> 4^3 x 256
             + 2 * 4 ** 3 * 256 * 128 * k3   # convt1: 4^3 x 256 -> 8^3 x 128
             + 2 * 8 ** 3 * 128 * 64 * k3    # convt2: 8^3 x 128 -> 16^3 x 64
             + 2 * 16 ** 3 * 64 * 1 * k3)    # convt3: 16^3 x 64 -> 32^3 x 1
    d_fwd = (2 * 16 ** 3 * 64 * 1 * k3       # conv0: 32^3 x 1 -> 16^3 x 64
             + 2 * 8 ** 3 * 128 * 64 * k3    # conv1 -> 8^3 x 128
             + 2 * 4 ** 3 * 256 * 128 * k3   # conv2 -> 4^3 x 256
             + 2 * 1 * 1 * 256 * k3)         # conv3 -> 1^3 x 1
    g_first, d_first = 2 * 128 * 256 * k3, 2 * 16 ** 3 * 64 * k3
    assert abs(g_fwd - 0.843e9) < 1e6 and abs(d_fwd - 0.839e9) < 1e6
    g_step = g_fwd + d_fwd + d_fwd + (g_fwd - g_first) + g_fwd
    d_step = g_fwd + 2 * (d_fwd + d_fwd + (d_fwd - d_first))
    work = voxel_counts.batch_work(cfg, 64)
    assert voxel_counts.total_flops(voxel_counts.g_step(cfg, 64)) == 64 * g_step
    assert voxel_counts.total_flops(voxel_counts.d_step(cfg, 64)) == 64 * d_step
    assert abs(voxel_counts.total_flops(work) - 641e9) < 1e9        # about 641 GFLOP a batch
    conv1 = voxel_counts.discriminator_layers(cfg)[1]
    assert voxel_counts.forward(conv1, 64)[1] == 4 * (64 * 64 * 16 ** 3 + 128 * 64 * k3 + 128
                                                      + 64 * 128 * 8 ** 3)
    assert [c.size_out for c in voxel_counts.generator_layers(cfg)] == [4, 8, 16, 32]
    assert [c.size_out for c in voxel_counts.discriminator_layers(cfg)] == [16, 8, 4, 1]


GUARD = r"""
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "shapegan_tpu", "shapegan_tpu_torch"):
            raise ImportError(f"imported {name}")
sys.meta_path.insert(0, Refuse())
import benchmark.voxel_counts, benchmark.reference.voxel_gan
print("ok")
"""


def test_counts_and_reference_import_nothing_of_the_program():
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]

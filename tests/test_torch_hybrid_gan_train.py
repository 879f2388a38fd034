"""The port's hybrid GAN and hybrid WGAN trainers held against the JAX
package's on the CPU, part two: the D steps' gradients and moments from the
same parameters, batch and noise; checkpoints both ways; micro runs of both
entry points with their resume, and the divergence guard (part one, the
models and the G steps, is test_torch_hybrid_gan.py).

The voxel discriminator takes 32^3 volumes only, so the steps run at 32^3
with a batch of 2. Off a TPU the JAX trainers generate their volumes with
float32 XLA while the port runs the bf16 plain versions of its kernels, so
the D steps are compared given the JAX step's own fakes.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.models import gan as jax_gan_models
from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu.ops import losses as jax_losses
from shapegan_tpu.ops.coords import voxel_coordinates as jax_voxel_coordinates
from shapegan_tpu.train import hybrid_gan as jax_gan
from shapegan_tpu.train import hybrid_wgan as jax_wgan
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.models import gan
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.optim import Adam, RMSprop
from shapegan_tpu_torch.train import hybrid_gan as trainer
from shapegan_tpu_torch.train import hybrid_wgan as wgan_trainer
from shapegan_tpu_torch.train.common import load_critic, load_generator

BATCH = 2
RES = 32
# float32 convolutions on both sides: only summation order differs (read
# max 2.4e-7 on scores ~0.5 and ~0.05).
SCORE_ATOL = 1e-5
# Gradients and moments of the D steps given identical fakes, against the
# largest entry (float32 on both sides; read <= 2.5e-6).
D_REL = 1e-4
# One RMSprop step from nu = 0 moves a parameter by lr g / sqrt(0.1 g^2 +
# 1e-8), continuous in g, so summation order moves it by ~1e-10 (read 0
# after the clip).
PARAM_ATOL = 1e-7
# The port's whole D step (its fakes from the bf16 plain grid kernel)
# against the JAX step's metrics: the bf16-vs-float32 distance of the
# volumes (read <= 2.0e-5).
METRIC_ATOL = 1e-3


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _port_disc(d_params, use_sigmoid=True):
    disc = gan.Discriminator(use_sigmoid)
    disc.load_state_dict(gan.params_from_jax(d_params))
    return disc


def _flat_port(grads):
    return gan.params_to_jax(grads)


@functools.lru_cache(maxsize=None)
def _jax_models(kind):
    """(flax net, flax critic, g_params, d_params) as the JAX trainer makes
    them, numpy leaves."""
    if kind == "gan":
        jnet, jdisc, g_params, _, d_state = jax_gan.create_states(jax.random.PRNGKey(0))
        d_params = d_state.params
    else:
        jnet = JaxSDFNet()
        g_rng, d_rng = jax.random.split(jax.random.PRNGKey(0))
        g_params = jnet.init(g_rng)
        jdisc = jax_gan_models.Discriminator(use_sigmoid=False)
        d_params = jdisc.init(d_rng, jnp.zeros((2,) + (RES,) * 3))["params"]
    return jnet, jdisc, jax.tree.map(np.asarray, g_params), jax.tree.map(np.asarray, d_params)


def _volumes(seed):
    return np.random.default_rng(seed).uniform(-0.1, 0.1, (BATCH,) + (RES,) * 3).astype(np.float32)


def _jax_fake(kind, rng):
    jnet, _, g_params, _ = _jax_models(kind)
    z = jax.random.normal(rng, (BATCH, 128))
    grid = jnp.asarray(jax_voxel_coordinates(RES))
    return np.asarray(z), np.asarray(jax_gan.generate_volumes_inference(jnet, g_params, grid, z, RES))


def test_gan_d_step_matches_jax():
    """The two BCE updates given the JAX step's fakes: each loss's gradients
    (the real one at the JAX step's intermediate parameters) and the Adam
    moments after both; then the port's whole D step within the bf16
    distance of the JAX step's metrics."""
    jnet, jdisc, g_params, d_params = _jax_models("gan")
    batch = _volumes(5)
    rng = jax.random.PRNGKey(3)
    z, fake = _jax_fake("gan", rng)
    tx = optax.adam(jax_gan.DISCRIMINATOR_LR)
    _, d_step = jax_gan.make_steps(jnet, jdisc, tx, batch_size=BATCH, resolution=RES)
    from flax.training import train_state
    state0 = train_state.TrainState.create(apply_fn=jdisc.apply,
                                           params=jax.tree.map(jnp.array, d_params), tx=tx)
    new_state, metrics = d_step(g_params, state0, jnp.asarray(batch), rng)

    def bce_grad(params, volumes, target):
        return jax.grad(lambda p: jax_losses.bce_loss(jdisc.apply({"params": p}, volumes),
                                                      jnp.full((BATCH,), target)))(params)

    g1 = bce_grad(d_params, fake, 0.0)
    updates, st = tx.update(g1, tx.init(d_params), d_params)
    params1 = jax.tree.map(np.asarray, optax.apply_updates(d_params, updates))
    g2 = bce_grad(params1, batch, 1.0)

    disc = _port_disc(d_params)
    d_opt = Adam(dict(disc.named_parameters()), jax_gan.DISCRIMINATOR_LR)
    grads1, pred_fake = trainer.bce_grads(disc, torch.tensor(fake), 0.0)
    d_opt.step(grads1)
    grads2_at_jax, _ = trainer.bce_grads(_port_disc(params1), torch.tensor(batch), 1.0)
    grads2, pred_real = trainer.bce_grads(disc, torch.tensor(batch), 1.0)
    d_opt.step(grads2)
    for got, want in ((grads1, g1), (grads2_at_jax, g2)):
        jax.tree.map(lambda a, b: _check_rel(a.numpy(), b, D_REL), _flat_port(got), want)
    moments = new_state.opt_state[0]
    jax.tree.map(lambda a, b: _check_rel(a.numpy(), b, D_REL), gan.params_to_jax(d_opt.mu), moments.mu)
    jax.tree.map(lambda a, b: _check_rel(a.numpy(), b, D_REL), gan.params_to_jax(d_opt.nu), moments.nu)
    assert int(d_opt.count) == int(moments.count) == 2
    assert abs(float(pred_fake.mean()) - float(metrics["pred_fake"])) <= SCORE_ATOL
    assert abs(float(pred_real.mean()) - float(metrics["pred_real"])) <= SCORE_ATOL

    net = SDFNet(sdf_mlp.params_from_jax(g_params))
    disc = _port_disc(d_params)
    _, port_d_step = trainer.make_steps(net, disc, Adam(net.param_dict(), 1e-3),
                                        Adam(dict(disc.named_parameters()), 1e-5), RES)
    full = port_d_step(torch.tensor(batch), torch.tensor(z))
    for key in ("pred_fake", "pred_real"):
        assert abs(float(full[key]) - float(metrics[key])) <= METRIC_ATOL, key


def _check_rel(got, want, bound):
    assert _rel(got, want) <= bound, _rel(got, want)


def test_wgan_critic_step_matches_jax():
    """The Wasserstein loss's gradients given the JAX step's fakes, the
    RMSprop moment, and the parameters after the update and the clip to
    +-0.01."""
    jnet, jcritic, g_params, d_params = _jax_models("wgan")
    batch = _volumes(6)
    rng = jax.random.PRNGKey(8)
    z, fake = _jax_fake("wgan", rng)
    tx = optax.rmsprop(jax_wgan.LEARN_RATE)
    critic_step, _ = jax_wgan.make_steps(jnet, jcritic, tx, BATCH, resolution=RES)
    from flax.training import train_state
    state0 = train_state.TrainState.create(apply_fn=jcritic.apply,
                                           params=jax.tree.map(jnp.array, d_params), tx=tx)
    new_state, metrics = critic_step(g_params, state0, jnp.asarray(batch), rng)
    want = jax.grad(lambda p: jnp.mean(jcritic.apply({"params": p}, fake))
                    - jnp.mean(jcritic.apply({"params": p}, batch)))(d_params)

    critic = _port_disc(d_params, use_sigmoid=False)
    grads, port_metrics = wgan_trainer.critic_grads(critic, torch.tensor(fake), torch.tensor(batch))
    jax.tree.map(lambda a, b: _check_rel(a.numpy(), b, D_REL), _flat_port(grads), want)
    for key in ("pred_fake", "pred_real"):
        assert abs(float(port_metrics[key]) - float(metrics[key])) <= SCORE_ATOL, key

    net = SDFNet(sdf_mlp.params_from_jax(g_params))
    critic = _port_disc(d_params, use_sigmoid=False)
    d_opt = RMSprop(dict(critic.named_parameters()), jax_wgan.LEARN_RATE)
    step, _ = wgan_trainer.make_steps(net, critic, Adam(net.param_dict(), 1e-5), d_opt, RES)
    # The step with the JAX fakes in place of its own.
    monkey = wgan_trainer.generate_volumes_inference
    wgan_trainer.generate_volumes_inference = lambda *a: torch.tensor(fake)
    try:
        step(torch.tensor(batch), torch.tensor(z))
    finally:
        wgan_trainer.generate_volumes_inference = monkey
    got = gan.params_to_jax(dict(critic.named_parameters()))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PARAM_ATOL,
                                                         rtol=0), got, new_state.params)
    jax.tree.map(lambda a, b: _check_rel(a.numpy(), b, D_REL), gan.params_to_jax(d_opt.nu),
                 new_state.opt_state[0].nu)
    assert max(float(p.detach().abs().max()) for p in critic.parameters()) <= wgan_trainer.CRITIC_WEIGHT_LIMIT
    # the init exceeds the limit, so the clip acted
    assert max(float(np.abs(v).max()) for v in jax.tree.leaves(d_params)) > 0.01


# ----------------------------------------------------- entry points, files


def _jax_templates(kind):
    """The JAX trainer's parameter and optimizer-sidecar trees (templates)."""
    _, _, g_params, d_params = _jax_models(kind)
    g_tx = optax.adam(1e-3)
    d_tx = optax.adam(1e-5) if kind == "gan" else optax.rmsprop(1e-5)
    opt = {"g": g_tx.init(g_params), "d": d_tx.init(d_params)}
    return g_params, d_params, opt


@pytest.mark.parametrize("kind", ["gan", "wgan"])
def test_entry_point_micro_run_resume_and_files(kind, tmp_path, monkeypatch):
    """cpu synthetic=4 batch_size=2 epochs=1, then continue to epochs=2:
    files, snapshots, the CSV schema (epoch time fake real), the step
    counts; the files load into the JAX package's templates (strict), and
    files the JAX package writes load into the port."""
    monkeypatch.chdir(tmp_path)
    module = trainer if kind == "gan" else wgan_trainer
    base = ["cpu", "synthetic=4", "batch_size=2"]
    first = module.train(parse_cli(base + ["epochs=1"]))
    resumed = module.train(parse_cli(base + ["epochs=2", "continue"]))
    assert first["steps"] == resumed["steps"] == 2  # 4 shapes, batch 2
    if kind == "wgan":
        assert first["g_steps"] == resumed["g_steps"] == 1  # batch 0 of each epoch
    with open(f"plots/hybrid_{kind}_training.csv") as f:
        rows = [line.split() for line in f]
    assert [r[0] for r in rows] == ["0", "1"] and all(len(r) == 4 for r in rows)
    assert all(np.isfinite(float(v)) for r in rows for v in r)
    for name in (module.G_NAME, module.D_NAME, module.OPT_NAME):
        assert os.path.exists(f"models/{name}.npz"), name
    for name in (module.G_NAME, module.D_NAME):
        for epoch in (0, 1):
            assert os.path.exists(f"models/checkpoints/{name}-epoch-{epoch:05d}.npz")

    g_params, d_params, opt = _jax_templates(kind)
    zeros = functools.partial(jax.tree.map, np.zeros_like)
    g_back = jax_checkpoints.load(zeros(g_params), module.G_NAME, base="models", strict=True)
    net = resumed["net"]
    for key, value in g_back.items():
        np.testing.assert_array_equal(value, net.param_dict()[key].detach().numpy())
    critic = resumed["discriminator" if kind == "gan" else "critic"]
    d_back = jax_checkpoints.load(zeros(d_params), module.D_NAME, base="models", strict=True)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.detach().numpy(), b),
                 gan.params_to_jax(dict(critic.named_parameters())), d_back)
    opt_back = jax_checkpoints.load(zeros(opt), module.OPT_NAME, base="models", strict=True)
    assert int(opt_back["g"][0].count) == (4 if kind == "gan" else 2)
    assert float(np.abs(opt_back["d"][0].nu["conv0"]["kernel"]).max()) > 0

    # The JAX package's files into the port.
    jax_checkpoints.save(g_params, "g", base="jax")
    jax_checkpoints.save(d_params, "d", base="jax")
    net = SDFNet()
    load_generator(net, "g", "jax")
    for key, value in g_params.items():
        np.testing.assert_array_equal(net.param_dict()[key].detach().numpy(), value)
    disc = gan.Discriminator(use_sigmoid=kind == "gan", generator=torch.Generator().manual_seed(9))
    load_critic(disc, "d", "jax")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.detach().numpy(), b),
                 gan.params_to_jax(dict(disc.named_parameters())), d_params)


def test_optimizer_sidecar_from_jax_loads(tmp_path):
    """A sidecar the JAX hybrid GAN trainer wrote after a step restores the
    port's two Adams (count, mu, nu in each layout)."""
    jnet, jdisc, g_params, d_params = _jax_models("gan")
    tx = optax.adam(1e-5)
    _, d_step = jax_gan.make_steps(jnet, jdisc, tx, batch_size=BATCH, resolution=RES)
    from flax.training import train_state
    state = train_state.TrainState.create(apply_fn=jdisc.apply,
                                          params=jax.tree.map(jnp.array, d_params), tx=tx)
    state, _ = d_step(g_params, state, jnp.asarray(_volumes(7)), jax.random.PRNGKey(1))
    g_tx = optax.adam(1e-3)
    jax_checkpoints.save({"g": g_tx.init(g_params), "d": state.opt_state}, trainer.OPT_NAME,
                         base=str(tmp_path))
    net, disc, g_opt, d_opt = trainer.create_states()
    trainer._load_optimizers(g_opt, d_opt, str(tmp_path))
    assert int(g_opt.count) == 0 and int(d_opt.count) == 2
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 gan.params_to_jax(d_opt.mu), state.opt_state[0].mu)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 gan.params_to_jax(d_opt.nu), state.opt_state[0].nu)


def test_divergence_guard_saves_nothing(tmp_path, monkeypatch, capsys):
    """When the rolling D(fake) and D(real) lie apart by more than the limit,
    the run prints 'Network diverged.' and stops before saving that epoch."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer, "DIVERGENCE_LIMIT", -1.0)
    result = trainer.train(parse_cli(["cpu", "synthetic=4", "batch_size=2", "epochs=2"]))
    assert "Network diverged." in capsys.readouterr().out
    assert result["steps"] == 2  # one epoch ran
    assert not os.path.exists("models")
    with open("plots/hybrid_gan_training.csv") as f:
        assert f.read() == ""

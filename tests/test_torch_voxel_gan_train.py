"""The port's voxel GAN and WGAN entry points held against the JAX
package's on the CPU: the micro runs with their resume and ``save_every``;
checkpoints both ways (the network, its BatchNorm statistics and its
optimizer's state in one file). The steps are in test_torch_voxel_gan.py,
whose helpers this file shares."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.core.config import TrainConfig as JaxTrainConfig
from shapegan_tpu.models.gan import Discriminator as JaxDiscriminator
from shapegan_tpu.models.gan import Generator as JaxGenerator
from shapegan_tpu.train import gan as jax_gan
from shapegan_tpu.train import wgan as jax_wgan
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.models import flax_layers
from shapegan_tpu_torch.train import gan as trainer
from shapegan_tpu_torch.train import wgan as wgan_trainer
from test_torch_voxel_gan import BATCH, _batch, _jax_states, _jax_variables, _one_thread  # noqa: F401


def _jax_payload_templates(kind):
    """Zeroed JAX trees of the trainer's two files (params, batch_stats,
    opt_state, epoch)."""
    use_sigmoid = kind == "gan"
    g_vars, d_params = _jax_variables(use_sigmoid)
    g_tx = optax.adam(1e-3) if kind == "gan" else optax.rmsprop(5e-5)
    d_tx = optax.adam(1e-5) if kind == "gan" else optax.rmsprop(5e-5)
    g = {"params": g_vars["params"], "batch_stats": g_vars["batch_stats"],
         "opt_state": g_tx.init(g_vars["params"]), "epoch": 0}
    d = {"params": d_params, "opt_state": d_tx.init(d_params), "epoch": 0}
    return jax.tree.map(np.zeros_like, g), jax.tree.map(np.zeros_like, d)


@pytest.mark.parametrize("kind", ["gan", "wgan"])
def test_entry_point_micro_run_resume_and_files(kind, tmp_path, monkeypatch):
    """cpu synthetic=8 batch_size=4 epochs=1, then continue to epochs=2:
    the step counts, the CSV (epoch time fake real), latest files and
    snapshots; the files load through the JAX package's checkpoints with its
    trainer's templates (strict) and hold the port's networks, statistics
    and moments; files the JAX package writes restore into the port."""
    monkeypatch.chdir(tmp_path)
    module = trainer if kind == "gan" else wgan_trainer
    base = ["cpu", "synthetic=8", "batch_size=4"]
    first = module.train(parse_cli(base + ["epochs=1"]))
    resumed = module.train(parse_cli(base + ["epochs=2", "continue"]))
    assert first["steps"] == resumed["steps"] == 2  # 8 shapes, batch 4
    if kind == "wgan":
        assert first["g_steps"] == resumed["g_steps"] == 1  # batch 0 of each epoch
    with open(f"plots/{kind}_training.csv") as f:
        rows = [line.split() for line in f]
    assert [r[0] for r in rows] == ["0", "1"] and all(len(r) == 4 for r in rows)
    assert all(np.isfinite(float(v)) for r in rows for v in r)
    assert os.path.exists(f"models/checkpoints/{module.G_NAME}-epoch-00000.npz")
    assert not os.path.exists(f"models/checkpoints/{module.G_NAME}-epoch-00001.npz")

    g_template, d_template = _jax_payload_templates(kind)
    g_back = jax_checkpoints.load(g_template, module.G_NAME, base="models", strict=True)
    d_back = jax_checkpoints.load(d_template, module.D_NAME, base="models", strict=True)
    g_net = resumed["generator"]
    d_net = resumed["discriminator" if kind == "gan" else "critic"]
    assert int(g_back["epoch"]) == int(d_back["epoch"]) == 1
    # Adam's counts: one G update and two D updates a step, 4 steps.
    for net, opt, back, count in ((g_net, resumed["g_opt"], g_back, 4),
                                  (d_net, resumed["d_opt"], d_back, 8)):
        ours = flax_layers.variables_to_jax(net)
        for collection in ours:
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                         ours[collection], back[collection])
        for name, moments in opt.state().items():
            if name == "count":
                assert int(moments) == int(back["opt_state"][0].count) == count
                continue
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                         flax_layers.to_jax(net, moments), getattr(back["opt_state"][0], name))

    # The JAX package's files (a state after one JAX step) into the port.
    use_sigmoid = kind == "gan"
    g_tx = optax.adam(1e-3) if kind == "gan" else optax.rmsprop(5e-5)
    d_tx = optax.adam(1e-5) if kind == "gan" else optax.rmsprop(5e-5)
    g_state, d_state = _jax_states(use_sigmoid, g_tx, d_tx)
    if kind == "gan":
        g_state, d_state, _, _ = jax_gan.train_step(JaxGenerator(), JaxDiscriminator(True), g_state,
                                                    d_state, jnp.asarray(_batch(3)),
                                                    jax.random.PRNGKey(1))
    else:
        d_state, _ = jax_wgan.critic_step(JaxGenerator(), JaxDiscriminator(False), g_state, d_state,
                                          jnp.asarray(_batch(3)), jax.random.PRNGKey(1))
        g_state, _, _ = jax_wgan.generator_step(JaxGenerator(), JaxDiscriminator(False), g_state,
                                                d_state, BATCH, jax.random.PRNGKey(2))
    jax_gan.save(JaxTrainConfig(model_dir="jax"), g_state, d_state, "g", "d", 7, False)
    g_net, d_net, g_opt, d_opt = module.create_states(seed=9)
    trainer.restore(g_net, d_net, g_opt, d_opt, "g", "d", "jax")
    for net, opt, state in ((g_net, g_opt, g_state), (d_net, d_opt, d_state)):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                     flax_layers.variables_to_jax(net)["params"], state.params)
        for name, moments in opt.state().items():
            if name != "count":
                jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                             flax_layers.to_jax(net, moments), getattr(state.opt_state[0], name))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 flax_layers.variables_to_jax(g_net)["batch_stats"], g_state.batch_stats)
    if kind == "gan":
        assert int(g_opt.count) == 1 and int(d_opt.count) == 2


def test_gan_save_every_thins_latest_slot(tmp_path, monkeypatch):
    """save_every=3 over 5 epochs saves in epochs 0 (the snapshot cadence),
    2 ((2 + 1) % 3 == 0) and 4 (the last), as the JAX trainer; the CSV keeps
    a line an epoch."""
    monkeypatch.chdir(tmp_path)
    calls = []
    save = trainer.save

    def counting_save(*args):
        calls.append(args[7])
        return save(*args)

    monkeypatch.setattr(trainer, "save", counting_save)
    trainer.train(parse_cli(["cpu", "synthetic=4", "batch_size=4", "epochs=5", "save_every=3"]))
    assert calls == [0, 2, 4]
    with open("plots/gan_training.csv") as f:
        assert len(f.read().splitlines()) == 5

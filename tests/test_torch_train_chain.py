"""The port's progressive WGAN-GP trainer on the CPU: checkpoints in both
directions between the port and the JAX package, and a micro chain through
the trainer's entry point (iterations 0 -> 1, resume, the live viewer's
calls against the JAX trainer's).
Iterations 2-3 run on the card (chip_smoke.py, phase 6)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.core.config import TrainConfig as JaxTrainConfig
from shapegan_tpu.train import hybrid_progressive_gan as jax_trainer
from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.models import progressive_gan
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer
from shapegan_tpu_torch.train.common import load_critic, load_generator

BATCH = 2
LR = 1e-4


def _jax_models(seed=0):
    net, critic, g_params, d_params = jax_trainer.create_models(seed)
    return net, critic, jax.tree.map(np.asarray, g_params), jax.tree.map(np.asarray, d_params)


def test_checkpoints_load_both_ways(tmp_path):
    """JAX-saved G, D and optimizer sidecar load into the port's templates;
    the port's trainer's files load into JAX checkpoints.load(strict=True)."""
    jnet, jcritic, g_params, d_params = _jax_models(seed=2)
    tx = optax.rmsprop(LR)
    _, d_step = jax_trainer.make_steps(jnet, jcritic, tx, tx, 0, BATCH)
    batch = jnp.asarray(np.random.default_rng(0).uniform(-0.1, 0.1, (BATCH, 8, 8, 8)), jnp.float32)
    d_params, d_state, _ = d_step(g_params, d_params, tx.init(d_params), batch, jax.random.PRNGKey(0), 1.0)
    opt_tree = {"g": tx.init(g_params), "d": d_state}
    base = str(tmp_path / "jax")
    jax_checkpoints.save(g_params, "g", base=base)
    jax_checkpoints.save(d_params, "d", base=base)
    jax_checkpoints.save(opt_tree, "opt", base=base)

    net, critic = trainer.create_models(seed=5)
    load_generator(net, "g", base)
    load_critic(critic, "d", base)
    for key, value in g_params.items():
        np.testing.assert_array_equal(net.param_dict()[key].detach().numpy(), value)
    got = progressive_gan.params_to_jax(dict(critic.named_parameters()))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), got, d_params)
    g_opt = RMSprop(net.param_dict(), LR)
    d_opt = RMSprop(dict(critic.named_parameters()), LR)
    flat = checkpoints._flatten(trainer._optimizer_tree(g_opt, d_opt))
    assert len(flat) == 31 and "g/0/nu/w1p" in flat and "d/0/nu/head_dense2/bias" in flat
    restored = checkpoints.load_tree(trainer._optimizer_tree(g_opt, d_opt), "opt", base=base,
                                     strict=True)
    d_nu = restored["d"][0]["nu"]
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), d_nu,
                 jax.tree.map(np.asarray, d_state[0].nu))

    # The port's own files, written by its trainer, into JAX.
    out = tmp_path / "port"
    result = trainer.train(parse_cli(["cpu", "synthetic=2", "batch_size=2", "epochs=1",
                                      f"--model_dir={out}/models", f"--plot_dir={out}/plots"]))
    g_back = jax_checkpoints.load(jax.tree.map(np.zeros_like, g_params), trainer.G_NAME.format(0),
                                  base=f"{out}/models", strict=True)
    for key, value in g_back.items():
        np.testing.assert_array_equal(value, result["net"].param_dict()[key].detach().numpy())
    d_back = jax_checkpoints.load(jax.tree.map(np.zeros_like, d_params), trainer.D_NAME.format(0),
                                  base=f"{out}/models", strict=True)
    got = progressive_gan.params_to_jax(dict(result["discriminator"].named_parameters()))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), got, d_back)
    opt_back = jax_checkpoints.load(jax.tree.map(np.zeros_like, opt_tree), trainer.OPT_NAME.format(0),
                                    base=f"{out}/models", strict=True)
    assert float(np.abs(opt_back["d"][0].nu["head_dense1"]["kernel"]).max()) > 0


def test_micro_chain_cpu(tmp_path, monkeypatch):
    """The entry point for iterations 0 -> 1 at a micro budget: iteration 1
    warm-starts from iteration 0's checkpoints (with learning rate 0 its
    final weights are exactly those), writes its files and CSV line, and
    resumes with 'continue' from the CSV's epoch count."""
    monkeypatch.chdir(tmp_path)
    base = ["cpu", "synthetic=4", "batch_size=2", "epochs=1"]
    first = trainer.train(parse_cli(base + ["iteration=0"]))
    second = trainer.train(parse_cli(base + ["iteration=1", "learn_rate=0"]))
    for key, value in first["net"].param_dict().items():
        torch.testing.assert_close(second["net"].param_dict()[key], value, rtol=0, atol=0)
    for (key, value), other in zip(first["discriminator"].named_parameters(),
                                   second["discriminator"].parameters()):
        torch.testing.assert_close(other, value, rtol=0, atol=0)
    fresh, _ = trainer.create_models(0)
    assert not torch.equal(fresh.param_dict()["w2"], first["net"].param_dict()["w2"])
    for iteration in (0, 1):
        for name in (trainer.G_NAME, trainer.D_NAME, trainer.OPT_NAME):
            assert os.path.exists(f"models/{name.format(iteration)}.npz")
        assert os.path.exists(f"models/checkpoints/{trainer.G_NAME.format(iteration)}-epoch-00000.npz")
        with open(f"plots/hybrid_gan_training_{iteration}.csv") as f:
            rows = [line.split() for line in f]
        assert len(rows) == 1 and len(rows[0]) == 5 and rows[0][0] == "0"
        assert all(np.isfinite(float(v)) for v in rows[0]) and float(rows[0][4]) >= 0
    # 4 shapes, batch 2: two D steps an epoch, a G step every 5th batch.
    assert (len(first["g_step_s"]), len(first["d_step_s"])) == (1, 2)
    resumed = trainer.train(parse_cli(base[:-1] + ["epochs=2", "iteration=1", "continue"]))
    assert len(resumed["d_step_s"]) == 2
    with open("plots/hybrid_gan_training_1.csv") as f:
        assert [line.split()[0] for line in f] == ["0", "1"]
    # ``gui`` is no longer refused: with the live viewer a recorder in both
    # packages, iteration 0 shows the G step's first fake volume at the JAX
    # trainer's batches (their latents are each package's own draws), then
    # stops the viewer.
    shown = {"jax": [], "port": []}

    class Recorder:
        def __init__(self, side):
            self.side = side

        def set_voxels(self, voxels):
            volume = np.asarray(voxels.detach() if isinstance(voxels, torch.Tensor) else voxels)
            shown[self.side].append(volume.shape)
            assert np.isfinite(volume).all() and np.abs(volume).max() <= 0.1 + 1e-6

        def stop(self):
            shown[self.side].append("stop")

    monkeypatch.setattr(jax_trainer, "make_viewer", lambda nogui: None if nogui else Recorder("jax"))
    monkeypatch.setattr(trainer, "make_viewer", lambda nogui: None if nogui else Recorder("port"))
    dirs = ["--model_dir=gui/models", "--plot_dir=gui/plots"]
    trainer.train(parse_cli(base + ["iteration=0", "gui"] + dirs))
    jax_trainer.train(JaxTrainConfig(iteration=0, synthetic=4, batch_size=2, epochs=1, nogui=False,
                                     model_dir="gui_jax/models", plot_dir="gui_jax/plots"))
    assert shown["port"] == shown["jax"] == [(8, 8, 8), "stop"]

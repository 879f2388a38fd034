"""The port's (variational) autoencoder entry point held against the JAX
package's on the CPU: the micro runs, with the resume from the checkpoint's
epoch; checkpoints both ways (parameters, BatchNorm statistics and Adam's
state in one file). The steps are in test_torch_autoencoder.py, whose
helpers this file shares."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from shapegan_tpu.train import autoencoder as jax_ae
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.models import flax_layers
from shapegan_tpu_torch.train import autoencoder as trainer
from test_torch_autoencoder import _jax_state, _one_thread, _volumes  # noqa: F401


@pytest.mark.parametrize("variational", [False, True], ids=["classic", "vae"])
def test_entry_point_resume_and_files(variational, tmp_path, monkeypatch):
    """cpu [classic] synthetic=8 batch_size=4 epochs=1, then continue to
    epochs=2: the CSV (epoch time reconstruction kld voxel_diff), the latest
    file (epoch 1) and the snapshot of epoch 0; the file loads through the
    JAX package's checkpoints with its trainer's template (strict) and holds
    the port's model and moments. A file the JAX package writes (epoch 4)
    restores into the port, which resumes at epoch 5."""
    monkeypatch.chdir(tmp_path)
    name = "variational-autoencoder-128" if variational else "autoencoder-128"
    csv = f"plots/{'variational_' if variational else ''}autoencoder_training.csv"
    base = ["cpu", "synthetic=8", "batch_size=4"] + ([] if variational else ["classic"])
    first = trainer.train(parse_cli(base + ["epochs=1"]))
    resumed = trainer.train(parse_cli(base + ["epochs=2", "continue"]))
    assert first["steps"] == resumed["steps"] == 2  # 8 shapes, batch 4; the resume runs epoch 1
    with open(csv) as f:
        rows = [line.split() for line in f]
    assert [r[0] for r in rows] == ["0", "1"] and all(len(r) == 5 for r in rows)
    assert all(np.isfinite(float(v)) for r in rows for v in r)
    assert (float(rows[0][3]) > 0) == variational
    assert os.path.exists(f"models/checkpoints/{name}-epoch-00000.npz")
    assert not os.path.exists(f"models/checkpoints/{name}-epoch-00001.npz")

    state = _jax_state(variational)
    template = jax.tree.map(np.zeros_like, {"params": state.params, "batch_stats": state.batch_stats,
                                            "opt_state": state.opt_state, "epoch": 0})
    back = jax_checkpoints.load(template, name, base="models", strict=True)
    assert int(back["epoch"]) == 1 and int(back["opt_state"][0].count) == 4
    model, opt = resumed["model"], resumed["opt"]
    ours = flax_layers.variables_to_jax(model)
    for collection in ("params", "batch_stats"):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b), ours[collection],
                     back[collection])
    for moment in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                     flax_layers.to_jax(model, getattr(opt, moment)),
                     getattr(back["opt_state"][0], moment))

    state, _, _ = jax_ae.train_step(JaxAutoencoder(is_variational=variational), state,
                                    jnp.asarray(_volumes(2)), jax.random.PRNGKey(1))
    jax_checkpoints.save({"params": state.params, "batch_stats": state.batch_stats,
                          "opt_state": state.opt_state, "epoch": 4}, name, base="jax")
    restored = trainer.train(parse_cli(base + ["epochs=6", "continue", "model_dir=jax",
                                               "plot_dir=jax_plots"]))
    assert restored["steps"] == 2  # epoch 5 only
    with open(csv.replace("plots", "jax_plots")) as f:
        assert [line.split()[0] for line in f] == ["5"]
    assert int(restored["opt"].count) == 1 + 2


def test_resumed_model_is_the_jax_file(tmp_path):
    """The JAX file's parameters, statistics and moments land in the port's
    model and optimizer unchanged (before any step)."""
    from shapegan_tpu_torch.train.common import load_network

    state = _jax_state(True)
    state, _, _ = jax_ae.train_step(JaxAutoencoder(is_variational=True), state,
                                    jnp.asarray(_volumes(3)), jax.random.PRNGKey(2))
    jax_checkpoints.save({"params": state.params, "batch_stats": state.batch_stats,
                          "opt_state": state.opt_state, "epoch": 9},
                         "variational-autoencoder-128", base=str(tmp_path))
    model, opt = trainer.create_state(True, seed=5)
    epoch = load_network(model, opt, "variational-autoencoder-128", str(tmp_path))
    assert epoch == 9 and int(opt.count) == 1
    ours = flax_layers.variables_to_jax(model)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 ours["params"], state.params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 ours["batch_stats"], state.batch_stats)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 flax_layers.to_jax(model, opt.mu), state.opt_state[0].mu)

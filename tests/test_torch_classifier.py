"""The port's voxel classifier trainer held against the JAX package's on the
CPU: the synthetic labelled dataset (equal arrays), one training step from
the same parameters and batch, the entry point's micro run with its resume,
and the checkpoints (parameters, and Adam's state in its own file) both
ways."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.models.classifier import Classifier as JaxClassifier
from shapegan_tpu.train import classifier as jax_classifier
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.models import flax_layers
from shapegan_tpu_torch.models.classifier import Classifier
from shapegan_tpu_torch.optim import Adam
from shapegan_tpu_torch.train import classifier as trainer

BATCH = 4
# Loss and accuracy (read 8.6e-8 relative on the loss; the accuracy equal).
LOSS_REL = 1e-5
# Adam's moments against the tensor's largest entry (float32, ReLU kinks;
# read <= 5.5e-6).
MOMENT_REL = 1e-4
# Parameters where |g| >= 1e-3 x the tensor's largest, in Adam steps (lr;
# read <= 1.5e-4 lr).
PARAM_LR = 0.01


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


@functools.lru_cache(maxsize=None)
def _jax_params():
    variables = jax.jit(JaxClassifier(4).init)(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 32)))
    return jax.tree.map(np.asarray, variables["params"])


@pytest.mark.parametrize("count,seed", [(3, 0), (2, 5)])
def test_synthetic_class_dataset_equals_jax(count, seed):
    got = trainer.make_synthetic_class_dataset(count, seed=seed)
    want = jax_classifier.make_synthetic_class_dataset(count, seed=seed)
    assert got[2] == want[2] == 4
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert sorted(set(got[1].tolist())) == [0, 1, 2, 3]


def test_train_step_matches_jax():
    """Cross entropy on integer labels, one Adam step: the loss, the
    accuracy, the moments and the parameters."""
    volumes, labels, _ = jax_classifier.make_synthetic_class_dataset(2, seed=1)
    volumes, labels = volumes[:BATCH], labels[:BATCH]
    model_j = JaxClassifier(4)
    state = train_state.TrainState.create(apply_fn=model_j.apply, params=_jax_params(),
                                          tx=optax.adam(jax_classifier.LEARNING_RATE))
    new_state, metrics = jax_classifier.train_step(model_j, state, jnp.asarray(volumes),
                                                   jnp.asarray(labels))

    model = Classifier(4)
    flax_layers.load_variables(model, {"params": _jax_params()})
    opt = Adam(dict(model.named_parameters()), jax_classifier.LEARNING_RATE)
    got = trainer.make_step(model, opt)(torch.tensor(volumes), torch.tensor(labels))
    assert abs(float(got["loss"]) - float(metrics["loss"])) <= LOSS_REL * float(metrics["loss"])
    assert float(got["accuracy"]) == float(metrics["accuracy"])
    params = flax_layers.to_jax(model, dict(model.named_parameters()))
    lr = jax_classifier.LEARNING_RATE
    for layer, leaves in new_state.params.items():
        for leaf, want in leaves.items():
            want_mu = np.asarray(new_state.opt_state[0].mu[layer][leaf])
            for name in ("mu", "nu"):
                m_want = np.asarray(getattr(new_state.opt_state[0], name)[layer][leaf])
                m_got = flax_layers.to_jax(model, getattr(opt, name))[layer][leaf].numpy()
                assert _err(m_got, m_want) <= MOMENT_REL * np.abs(m_want).max(), (layer, leaf, name)
            clear = np.abs(want_mu) >= 1e-3 * np.abs(want_mu).max()
            got_p, want = params[layer][leaf].numpy(), np.asarray(want)
            assert _err(got_p[clear], want[clear]) <= PARAM_LR * lr, (layer, leaf)
            assert _err(got_p, want) <= 2 * lr, (layer, leaf)


def test_entry_point_micro_run_resume_and_files(tmp_path, monkeypatch):
    """cpu synthetic=2 batch_size=4 epochs=1 (8 volumes: 2 steps), then
    continue with epochs=2: both files restored, the CSV appended (epoch
    time loss accuracy; the epochs count from 0 again, the JAX trainer's
    rule); the files load through the JAX package's checkpoints with its
    trainer's templates (strict), and the JAX package's files restore into
    the port."""
    monkeypatch.chdir(tmp_path)
    base = ["cpu", "synthetic=2", "batch_size=4"]
    first = trainer.train(parse_cli(base + ["epochs=1"]))
    resumed = trainer.train(parse_cli(base + ["epochs=2", "continue"]))
    assert first["steps"] == 2 and resumed["steps"] == 4
    assert int(resumed["opt"].count) == 6  # the restored 2, then 4
    with open("plots/classifier_training.csv") as f:
        rows = [line.split() for line in f]
    assert [r[0] for r in rows] == ["0", "0", "1"] and all(len(r) == 4 for r in rows)
    assert all(np.isfinite(float(v)) for r in rows for v in r)
    assert all(0.0 <= float(r[3]) <= 1.0 for r in rows)

    zeros = functools.partial(jax.tree.map, np.zeros_like)
    params = _jax_params()
    tx = optax.adam(jax_classifier.LEARNING_RATE)
    back = jax_checkpoints.load(zeros(params), trainer.NAME, base="models", strict=True)
    opt_back = jax_checkpoints.load(zeros(tx.init(params)), trainer.NAME + "_optimizer",
                                    base="models", strict=True)
    model, opt = resumed["model"], resumed["opt"]
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                 flax_layers.variables_to_jax(model)["params"], back)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                 flax_layers.to_jax(model, opt.mu), opt_back[0].mu)
    assert int(opt_back[0].count) == 6

    state = train_state.TrainState.create(apply_fn=JaxClassifier(4).apply, params=params, tx=tx)
    volumes, labels, _ = jax_classifier.make_synthetic_class_dataset(1, seed=3)
    state, _ = jax_classifier.train_step(JaxClassifier(4), state, jnp.asarray(volumes),
                                         jnp.asarray(labels))
    jax_checkpoints.save(state.params, trainer.NAME, base="jax")
    jax_checkpoints.save(state.opt_state, trainer.NAME + "_optimizer", base="jax")
    model = Classifier(4, torch.Generator().manual_seed(9))
    opt = Adam(dict(model.named_parameters()), jax_classifier.LEARNING_RATE)
    trainer.restore(model, opt, "jax")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 flax_layers.variables_to_jax(model)["params"], state.params)
    for name in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                     flax_layers.to_jax(model, getattr(opt, name)), getattr(state.opt_state[0], name))
    assert int(opt.count) == 1
    restored = trainer.train(parse_cli(base + ["epochs=1", "continue", "model_dir=jax",
                                               "plot_dir=jax_plots"]))
    assert int(restored["opt"].count) == 1 + 2

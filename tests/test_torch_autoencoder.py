"""The port's (variational) autoencoder trainer held against the JAX
package's on the CPU: one training step of the classic AE and of the VAE
from the same parameters, batch and noise (the VAE's eps recovered from the
JAX step's own key), in float32 and, for the VAE, in float64 on both sides.
The entry point and checkpoints are in test_torch_autoencoder_train.py.

The float32 step's gradients are themselves accurate to only ~1e-2: the L1
loss's sign and the LeakyReLUs' slopes flip where a value lies within
float32 noise of its kink, and BatchNorm's backward over 3 values a channel
at the 1^3 layers cancels. Against a float64 run of the same step the
port's float32 gradients miss by <= 9e-4 of a tensor's largest, the JAX
package's by <= 1.5e-2. So the float32 step holds the losses, the
reconstruction and the statistics tightly and the moments loosely, and the
float64 step holds everything to rounding.

Adam's first step moves a parameter by lr g / (|g| + 1e-8). Every bias that
feeds a BatchNorm (the encoder's convolutions, the dense layer before the
VAE's or the decoder's BatchNorm, the decoder's first three transposed
convolutions) is removed by it: its gradient is 0 in exact arithmetic and
float noise on both sides, so in float32 its moments are checked to be
noise and the parameter to have moved by no more than a step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from shapegan_tpu.train import autoencoder as jax_ae
from shapegan_tpu_torch.models import flax_layers
from shapegan_tpu_torch.models.autoencoder import Autoencoder
from shapegan_tpu_torch.optim import Adam
from shapegan_tpu_torch.train import autoencoder as trainer

BATCH = 3
# Losses and the sign difference (read <= 1.4e-6 relative).
METRIC_REL = 1e-5
# Reconstructions against their largest entry (read <= 1.3e-5).
OUTPUT_REL = 1e-4
# float32: Adam's moments against the tensor's largest entry (see above;
# read <= 4.0e-2).
MOMENT_REL = 0.1
# A gradient that BatchNorm cancels, against the network's largest (read
# <= 6.3e-7).
CANCELLED_REL = 1e-4
# Parameters where |g| >= 0.1 x the tensor's largest (no sign of such a
# gradient flips at the moments' tolerance), in Adam steps (lr; read <=
# 1.9e-5).
PARAM_LR = 1e-3
# float64 on both sides: the moments against the tensor's largest (read
# 2.9e-12), the parameters (read 3.3e-10: the port's bias correction is
# float32, optax's float64), losses and reconstructions (read 5e-14).
F64_MOMENT_REL = 1e-9
F64_PARAM_ATOL = 1e-8
F64_ATOL = 1e-10
# Running statistics after the step (read <= 4.8e-7).
STATS_ATOL = 1e-5
CANCELLED = {"enc_convs_0", "enc_convs_1", "enc_convs_2", "enc_convs_3", "enc_dense", "dec_dense",
             "dec_convts_0", "dec_convts_1", "dec_convts_2"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores, and PyTorch's default of a thread per core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


@functools.lru_cache(maxsize=None)
def _jax_variables(variational):
    model = JaxAutoencoder(is_variational=variational)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(functools.partial(model.init, train=True))(
        {"params": key, "reparam": key}, jnp.zeros((2, 32, 32, 32)))
    return jax.tree.map(np.asarray, dict(variables))


def _jax_state(variational):
    variables = _jax_variables(variational)
    return jax_ae.TrainState.create(apply_fn=JaxAutoencoder(is_variational=variational).apply,
                                    params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    tx=optax.adam(jax_ae.LEARNING_RATE))


def _volumes(seed):
    """SDF-like volumes: clamped to ±1 with inside and outside cells."""
    x = np.random.default_rng(seed).uniform(-1.5, 1.5, (BATCH, 32, 32, 32))
    return np.clip(x, -1, 1).astype(np.float32)


def _jax_eps(variational, batch, rng, variables=None):
    """The VAE's noise in the JAX step with key ``rng``: (z - mean) / std of
    the encoder run under the same key."""
    model = JaxAutoencoder(is_variational=variational)
    z, mean, log_variance = model.apply(
        variables or _jax_variables(variational), batch, train=True, rngs={"reparam": rng},
        return_mean_and_log_variance=True, method=JaxAutoencoder.encode, mutable=["batch_stats"])[0]
    return np.asarray((z - mean) / jnp.exp(log_variance * 0.5))


@pytest.mark.parametrize("variational", [False, True], ids=["classic", "vae"])
def test_train_step_matches_jax(variational):
    """One step: the metrics, the reconstruction, Adam's moments, the
    parameters and the running statistics."""
    state = _jax_state(variational)
    batch = _volumes(1)
    rng = jax.random.PRNGKey(4)
    model_j = JaxAutoencoder(is_variational=variational)
    new_state, metrics, output = jax_ae.train_step(model_j, state, jnp.asarray(batch), rng)
    eps = _jax_eps(variational, batch, rng) if variational else None

    model = Autoencoder(variational)
    flax_layers.load_variables(model, _jax_variables(variational))
    opt = Adam(dict(model.named_parameters()), jax_ae.LEARNING_RATE)
    got, got_output = trainer.make_step(model, opt)(
        torch.tensor(batch), None if eps is None else torch.tensor(eps))
    for key in ("reconstruction_loss", "kld_loss", "voxel_diff"):
        want = float(metrics[key])
        assert abs(float(got[key]) - want) <= METRIC_REL * max(abs(want), 1e-6), key
    if variational:
        assert float(got["kld_loss"]) > 0
    assert _err(got_output.numpy(), output) <= OUTPUT_REL * np.abs(np.asarray(output)).max()

    params = flax_layers.to_jax(model, dict(model.named_parameters()))
    moments = {name: flax_layers.to_jax(model, getattr(opt, name)) for name in ("mu", "nu")}
    jax_moments = new_state.opt_state[0]
    largest = max(float(np.abs(np.asarray(v)).max())
                  for leaves in jax_moments.mu.values() for v in leaves.values())
    lr = jax_ae.LEARNING_RATE
    for layer, leaves in new_state.params.items():
        for leaf, want in leaves.items():
            want, got_p = np.asarray(want), params[layer][leaf].numpy()
            want_mu = np.asarray(jax_moments.mu[layer][leaf])
            if layer in CANCELLED and leaf == "bias":
                assert np.abs(want_mu).max() <= CANCELLED_REL * largest, layer
                assert np.abs(moments["mu"][layer][leaf].numpy()).max() <= CANCELLED_REL * largest
                assert _err(got_p, want) <= 2 * lr, layer
                continue
            for name in ("mu", "nu"):
                m_want = np.asarray(getattr(jax_moments, name)[layer][leaf])
                err = _err(moments[name][layer][leaf].numpy(), m_want)
                assert err <= MOMENT_REL * np.abs(m_want).max(), (layer, leaf, name)
            clear = np.abs(want_mu) >= 0.1 * np.abs(want_mu).max()
            assert _err(got_p[clear], want[clear]) <= PARAM_LR * lr, (layer, leaf)
            assert _err(got_p, want) <= 2 * lr, (layer, leaf)
    assert int(opt.count) == int(jax_moments.count) == 1
    stats = flax_layers.variables_to_jax(model)["batch_stats"]
    for layer, leaves in new_state.batch_stats.items():
        for leaf, want in leaves.items():
            assert _err(stats[layer][leaf].numpy(), want) <= STATS_ATOL, (layer, leaf)


def test_vae_step_matches_jax_in_float64():
    """The VAE's step with float64 parameters, batch and noise on both sides
    (JAX in x64 mode): losses, reconstruction, moments, parameters and
    statistics agree to rounding."""
    f64 = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float64))
    variables = f64(_jax_variables(True))
    batch = _volumes(1).astype(np.float64)
    rng = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        state = jax_ae.TrainState.create(apply_fn=JaxAutoencoder().apply,
                                         params=variables["params"],
                                         batch_stats=variables["batch_stats"],
                                         tx=optax.adam(jax_ae.LEARNING_RATE))
        new_state, metrics, output = jax_ae.train_step(JaxAutoencoder(), state, jnp.asarray(batch), rng)
        eps = _jax_eps(True, batch, rng, variables)
        new_state, metrics, output = jax.tree.map(np.asarray, (new_state, metrics, output))
    assert output.dtype == np.float64

    model = Autoencoder(True).double()
    flax_layers.load_variables(model, variables)
    model.double()
    opt = Adam(dict(model.named_parameters()), jax_ae.LEARNING_RATE)
    got, got_output = trainer.make_step(model, opt)(torch.tensor(batch), torch.tensor(eps))
    for key in ("reconstruction_loss", "kld_loss", "voxel_diff"):
        assert abs(float(got[key]) - float(metrics[key])) <= F64_ATOL, key
    assert _err(got_output.numpy(), output) <= F64_ATOL
    params = flax_layers.to_jax(model, dict(model.named_parameters()))
    for name in ("mu", "nu"):
        moments = flax_layers.to_jax(model, getattr(opt, name))
        for layer, leaves in getattr(new_state.opt_state[0], name).items():
            for leaf, want in leaves.items():
                if layer in CANCELLED and leaf == "bias":
                    continue  # 0 in exact arithmetic: float64 noise on both sides
                err = _err(moments[layer][leaf].numpy(), want)
                assert err <= F64_MOMENT_REL * np.abs(want).max(), (layer, leaf, name)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=F64_PARAM_ATOL),
                 params, new_state.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=F64_ATOL),
                 flax_layers.variables_to_jax(model)["batch_stats"], new_state.batch_stats)

"""The port's voxel GAN and WGAN trainers held against the JAX package's on
the CPU: one GAN step (G step, then the D steps on fresh fakes and on the
real batch) and one WGAN critic step plus generator step from the same
parameters, batch and latents (drawn from the JAX step's own keys). The
entry points and checkpoints are in test_torch_voxel_gan_train.py.

Adam's first step moves a parameter by lr g / (|g| + 1e-8): about lr for
any gradient well above 1e-8, and by float noise times lr / 1e-8 for a
gradient near 0. The biases of the generator's first three transposed
convolutions feed a BatchNorm, which removes them: their gradient is 0 in
exact arithmetic and float noise (~1e-9) on both sides, so their moments
are checked to be noise and their parameters to have moved by no more than
a step. Elsewhere parameters are compared where the gradient stands out of
the noise, and the moments (the gradients) everywhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu.models.gan import Discriminator as JaxDiscriminator
from shapegan_tpu.models.gan import Generator as JaxGenerator
from shapegan_tpu.train import gan as jax_gan
from shapegan_tpu.train import wgan as jax_wgan
from flax.training import train_state
from shapegan_tpu_torch.models import flax_layers
from shapegan_tpu_torch.models.gan import Discriminator, Generator
from shapegan_tpu_torch.optim import Adam, RMSprop
from shapegan_tpu_torch.train import gan as trainer
from shapegan_tpu_torch.train import wgan as wgan_trainer

BATCH = 2
# Fakes of the same generator and latents (tanh, in [-1, 1]; read <= 3e-6).
FAKE_ATOL = 1e-4
# Moments (0.1 g for mu, 0.1 g^2 for nu), against the tensor's largest
# entry: the D steps on identical fakes, float32 on both sides (read <= 3.0e-6).
MOMENT_REL = 1e-4
# The G steps' moments: each side makes its own fakes, which differ by
# float32 noise (<= 3e-6), and where one of the discriminator's 5e5
# pre-activations lies that close to 0 its LeakyReLU takes the other slope
# on one side (read <= 3.7e-5).
G_MOMENT_REL = 1e-3
# A gradient that BatchNorm cancels, against the network's largest (read
# <= 6.8e-7 on both sides).
CANCELLED_REL = 1e-5
# Parameters where |g| >= 1e-3 x the tensor's largest, in optimizer steps
# (lr): Adam's second D step divides the two gradients' mean by their RMS,
# ill-conditioned where they nearly cancel (read <= 0.061 lr there; the G
# step 1.2e-4 lr, RMSprop 2e-5 lr).
PARAM_LR = 0.2
# Running statistics after the steps (read <= 2.4e-7).
STATS_ATOL = 1e-5
# Mean D / critic scores (read <= 3.2e-8).
SCORE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores, and PyTorch's default of a thread per core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def warm_cpu_tanh():
    """The first multithreaded ``torch.tanh`` of a CPU process has been seen
    to miss tanh by up to 7e-5 on saturated inputs (|x| > 4; every later
    call: 3e-8), which the discriminator's LeakyReLU kinks turn into 1e-3
    of gradient. One call first keeps the comparisons on the port's own
    numbers."""
    torch.tanh(torch.randn(2, 32, 32, 32, generator=torch.Generator().manual_seed(0)))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


@functools.lru_cache(maxsize=None)
def _jax_variables(use_sigmoid):
    """(generator variables, discriminator params) from a jitted JAX init
    (seed 0), numpy leaves."""
    g_rng, d_rng = jax.random.split(jax.random.PRNGKey(0))
    g_vars = jax.jit(functools.partial(JaxGenerator().init, train=True))(g_rng, jnp.zeros((2, 128)))
    d_vars = jax.jit(JaxDiscriminator(use_sigmoid).init)(d_rng, jnp.zeros((2, 32, 32, 32)))
    return jax.tree.map(np.asarray, dict(g_vars)), jax.tree.map(np.asarray, d_vars["params"])


def _jax_states(use_sigmoid, g_tx, d_tx):
    g_vars, d_params = _jax_variables(use_sigmoid)
    g_state = jax_gan.GenState.create(apply_fn=JaxGenerator().apply, params=g_vars["params"],
                                      batch_stats=g_vars["batch_stats"], tx=g_tx)
    d_state = train_state.TrainState.create(apply_fn=JaxDiscriminator(use_sigmoid).apply,
                                            params=d_params, tx=d_tx)
    return g_state, d_state


def _port_nets(g_vars, d_params, use_sigmoid):
    g_net = Generator()
    flax_layers.load_variables(g_net, g_vars)
    d_net = Discriminator(use_sigmoid)
    flax_layers.load_variables(d_net, {"params": d_params})
    return g_net, d_net


def _batch(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (BATCH, 32, 32, 32)).astype(np.float32)


def _cancelled(module, layer):
    return isinstance(module, Generator) and layer in ("convt0", "convt1", "convt2")


def _check_net(module, opt, jax_params, jax_moments, lr, moment_names, moment_rel):
    """Moments and parameters of ``module`` after its steps against the JAX
    state's (see the module docstring). No parameter moves by more than
    sqrt(10) lr a step (RMSprop's largest first step; Adam's is lr)."""
    got_params = flax_layers.to_jax(module, dict(module.named_parameters()))
    moments = {name: flax_layers.to_jax(module, getattr(opt, name)) for name in moment_names}
    mu_name = moment_names[0]
    largest = max(float(np.abs(np.asarray(v)).max())
                  for leaves in getattr(jax_moments, mu_name).values() for v in leaves.values())
    for layer, leaves in jax_params.items():
        for leaf, want in leaves.items():
            want = np.asarray(want)
            got = got_params[layer][leaf].numpy()
            want_mu = np.asarray(getattr(jax_moments, mu_name)[layer][leaf])
            if _cancelled(module, layer) and leaf == "bias":
                got_mu = moments[mu_name][layer][leaf].numpy()
                assert np.abs(want_mu).max() <= CANCELLED_REL * largest, (layer, leaf)
                assert np.abs(got_mu).max() <= CANCELLED_REL * largest, (layer, leaf)
                assert _err(got, want) <= 8 * lr, (layer, leaf)
                continue
            for name in moment_names:
                m_got = moments[name][layer][leaf].numpy()
                m_want = np.asarray(getattr(jax_moments, name)[layer][leaf])
                assert _err(m_got, m_want) <= moment_rel * np.abs(m_want).max(), (layer, leaf, name)
            clear = np.abs(want_mu) >= 1e-3 * np.abs(want_mu).max()
            assert _err(got[clear], want[clear]) <= PARAM_LR * lr, (layer, leaf)
            assert _err(got, want) <= 8 * lr, (layer, leaf)


def _check_stats(g_net, jax_stats):
    got = flax_layers.variables_to_jax(g_net)["batch_stats"]
    for layer, leaves in jax_stats.items():
        for leaf, want in leaves.items():
            assert _err(got[layer][leaf].numpy(), want) <= STATS_ATOL, (layer, leaf)


class FixedFakes(torch.nn.Module):
    """Stands in for the generator in a D step: returns the given fakes."""

    def __init__(self, fake):
        super().__init__()
        self.fake = torch.tensor(np.asarray(fake))

    def forward(self, z, train=True, update_stats=None):
        return self.fake


def _d_step_fakes(g_net, g_vars, z):
    """The fakes a D step makes from ``z`` with flax's generator (train mode,
    the update dropped); the port's generator makes the same and keeps its
    statistics."""
    want, _ = jax.jit(functools.partial(JaxGenerator().apply, train=True,
                                        mutable=["batch_stats"]))(g_vars, z)
    before = {k: v.clone() for k, v in g_net.state_dict().items()}
    with torch.no_grad():
        got = g_net(torch.tensor(z), train=True, update_stats=False)
    assert all(torch.equal(v, before[k]) for k, v in g_net.state_dict().items())
    assert _err(got.numpy(), want) <= FAKE_ATOL
    return np.asarray(want)


def test_gan_step_matches_jax():
    """The G step from the JAX step's initial state and latents; then the
    two D steps on the fakes of the JAX step's updated generator."""
    g_state, d_state = _jax_states(True, optax.adam(jax_gan.GENERATOR_LR),
                                   optax.adam(jax_gan.DISCRIMINATOR_LR))
    g_vars, d_params = _jax_variables(True)
    batch = _batch(1)
    rng = jax.random.PRNGKey(3)
    g_rng, d_rng = jax.random.split(rng)  # the keys train_step splits
    z_g = np.asarray(jax.random.normal(g_rng, (BATCH, 128)))
    z_d = np.asarray(jax.random.normal(d_rng, (BATCH, 128)))
    g1, d1, metrics, sample = jax_gan.train_step(JaxGenerator(), JaxDiscriminator(True), g_state,
                                                 d_state, jnp.asarray(batch), rng)

    g_net, d_net = _port_nets(g_vars, d_params, True)
    g_opt = Adam(dict(g_net.named_parameters()), jax_gan.GENERATOR_LR)
    g_step, _ = trainer.make_steps(g_net, d_net, g_opt, Adam(dict(d_net.named_parameters()), 1e-5))
    fake = g_step(torch.tensor(z_g))
    assert _err(fake.numpy(), sample) <= FAKE_ATOL
    _check_net(g_net, g_opt, g1.params, g1.opt_state[0], jax_gan.GENERATOR_LR, ("mu", "nu"),
               G_MOMENT_REL)
    _check_stats(g_net, jax.tree.map(np.asarray, g1.batch_stats))  # the D step's update is dropped
    assert int(g_opt.count) == int(g1.opt_state[0].count) == 1

    g1_vars = jax.tree.map(np.asarray, {"params": g1.params, "batch_stats": g1.batch_stats})
    g_net, d_net = _port_nets(g1_vars, d_params, True)
    fakes = FixedFakes(_d_step_fakes(g_net, g1_vars, z_d))
    d_opt = Adam(dict(d_net.named_parameters()), jax_gan.DISCRIMINATOR_LR)
    _, d_step = trainer.make_steps(fakes, d_net, Adam(dict(g_net.named_parameters()), 1e-3), d_opt)
    got = d_step(torch.tensor(batch), torch.tensor(z_d))
    for key in ("pred_fake", "pred_real"):
        assert abs(float(got[key]) - float(metrics[key])) <= SCORE_ATOL, key
    _check_net(d_net, d_opt, d1.params, d1.opt_state[0], jax_gan.DISCRIMINATOR_LR, ("mu", "nu"),
               MOMENT_REL)
    assert int(d_opt.count) == int(d1.opt_state[0].count) == 2


def test_wgan_steps_match_jax():
    """A critic step (the Wasserstein loss, RMSprop, the clip) on the fakes
    of the generator in train mode, then a generator step against the
    critic the JAX step updated, from the same state, batch and latents."""
    tx = optax.rmsprop(jax_wgan.LEARN_RATE)
    g_state, d_state = _jax_states(False, tx, tx)
    g_vars, d_params = _jax_variables(False)
    batch = _batch(2)
    c_rng, g_rng = jax.random.PRNGKey(4), jax.random.PRNGKey(5)
    d1, metrics = jax_wgan.critic_step(JaxGenerator(), JaxDiscriminator(False), g_state, d_state,
                                       jnp.asarray(batch), c_rng)
    g1, pred_fake, sample = jax_wgan.generator_step(JaxGenerator(), JaxDiscriminator(False), g_state,
                                                    d1, BATCH, g_rng)

    g_net, critic = _port_nets(g_vars, d_params, False)
    z_c = np.asarray(jax.random.normal(c_rng, (BATCH, 128)))  # what critic_step draws
    fakes = FixedFakes(_d_step_fakes(g_net, g_vars, z_c))
    d_opt = RMSprop(dict(critic.named_parameters()), jax_wgan.LEARN_RATE)
    critic_step, _ = wgan_trainer.make_steps(fakes, critic, RMSprop({}, 5e-5), d_opt)
    got = critic_step(torch.tensor(batch), torch.tensor(z_c))
    for key in ("pred_fake", "pred_real"):
        assert abs(float(got[key]) - float(metrics[key])) <= SCORE_ATOL, key
    _check_net(critic, d_opt, d1.params, d1.opt_state[0], jax_wgan.LEARN_RATE, ("nu",), MOMENT_REL)
    assert max(float(p.detach().abs().max()) for p in critic.parameters()) <= wgan_trainer.CRITIC_WEIGHT_LIMIT
    assert max(float(np.abs(v).max()) for v in jax.tree.leaves(d_params)) > 0.01  # the clip acted

    _, critic = _port_nets(g_vars, jax.tree.map(np.asarray, d1.params), False)
    g_opt = RMSprop(dict(g_net.named_parameters()), jax_wgan.LEARN_RATE)
    _, generator_step = wgan_trainer.make_steps(g_net, critic, g_opt, RMSprop({}, 5e-5))
    got_fake, got_sample = generator_step(torch.tensor(np.asarray(jax.random.normal(g_rng, (BATCH, 128)))))
    assert abs(float(got_fake) - float(pred_fake)) <= SCORE_ATOL
    assert _err(got_sample.numpy(), sample) <= FAKE_ATOL
    _check_net(g_net, g_opt, g1.params, g1.opt_state[0], jax_wgan.LEARN_RATE, ("nu",), G_MOMENT_REL)
    _check_stats(g_net, jax.tree.map(np.asarray, g1.batch_stats))

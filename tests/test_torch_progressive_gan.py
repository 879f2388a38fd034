"""The pieces of the port's progressive WGAN-GP trainer held against the JAX
package on the CPU: the progressive critic, the gradient penalty, RMSprop,
the synthetic voxel data and the batch order. Inputs are made with numpy
from a seed; noise the JAX package draws inside (the penalty's alpha) is
drawn with its keys here and handed to the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu.data.synthetic import make_voxel_dataset as jax_make_voxel_dataset
from shapegan_tpu.models.progressive_gan import ProgressiveDiscriminator as JaxCritic
from shapegan_tpu.ops.losses import gradient_penalty as jax_gradient_penalty
from shapegan_tpu.parallel.mesh import get_mesh
from shapegan_tpu.train.common import ResidentBatches as JaxResidentBatches
from shapegan_tpu_torch.data.synthetic import make_voxel_dataset
from shapegan_tpu_torch.models import progressive_gan
from shapegan_tpu_torch.models.progressive_gan import RESOLUTIONS, ProgressiveDiscriminator
from shapegan_tpu_torch.ops.losses import gradient_penalty
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.train.common import ResidentBatches

# float32 on both sides (JAX at 'highest' precision, see conftest.py); only
# the convolutions' summation order differs. Critic scores are ~0.05-0.1.
CRITIC_ATOL = 1e-5
# Gradients (of the penalty, through a double backward) relative to the
# largest entry of each tensor.
GRAD_REL = 1e-4
# RMSprop: the same float32 arithmetic in the same order; rsqrt may differ
# by an ulp (updates are ~1e-4 x O(1)).
RMSPROP_ATOL = 1e-9


@functools.lru_cache(maxsize=1)
def _jax_critic_params():
    """The JAX critic's parameters (numpy), initialised at the deepest
    iteration so every optional layer exists, as the trainer does."""
    variables = JaxCritic().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 64)), iteration=3)
    return jax.tree.map(np.asarray, variables["params"])


def _port_critic():
    critic = ProgressiveDiscriminator()
    critic.load_state_dict(progressive_gan.params_from_jax(_jax_critic_params()))
    return critic


def _volumes(seed, batch, res):
    return np.random.default_rng(seed).uniform(-0.1, 0.1, (batch, res, res, res)).astype(np.float32)


@pytest.mark.parametrize("iteration", range(4))
@pytest.mark.parametrize("fade", [0.3, 1.0])
def test_critic_matches_jax(iteration, fade):
    """Every iteration, mid fade-in and faded in, with the same weights."""
    x = _volumes(iteration, 2, RESOLUTIONS[iteration])
    ref = JaxCritic().apply({"params": _jax_critic_params()}, jnp.asarray(x), iteration=iteration,
                            fade_in_progress=fade)
    with torch.no_grad():
        out = _port_critic()(torch.tensor(x), iteration, fade)
    assert out.shape == (2,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=CRITIC_ATOL, rtol=0)


def test_critic_params_round_trip_and_init():
    """params_to_jax inverts params_from_jax exactly (DHWIO <-> OIDHW, Dense
    transposes, the head's channels-last rows unchanged); a fresh critic has
    the JAX tree's keys and shapes, within the init's bound
    1/sqrt(fan_in), fan_in = the product of the flax kernel's leading dims."""
    tree = _jax_critic_params()
    back = progressive_gan.params_to_jax(progressive_gan.params_from_jax(tree))
    assert set(back) == set(tree)
    for layer, leaves in tree.items():
        assert set(back[layer]) == set(leaves)
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf].numpy(), value)
    fresh = progressive_gan.params_to_jax(
        dict(ProgressiveDiscriminator(generator=torch.Generator().manual_seed(3)).named_parameters()))
    for layer, leaves in tree.items():
        bound = 1.0 / np.sqrt(np.prod(leaves["kernel"].shape[:-1]))
        for leaf, value in leaves.items():
            got = fresh[layer][leaf]
            assert tuple(got.shape) == value.shape, (layer, leaf)
            assert float(got.abs().max()) <= bound and float(np.abs(value).max()) <= bound
            assert float(got.abs().max()) > 0.5 * bound or got.numel() < 10, (layer, leaf)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / max(np.abs(np.asarray(ref)).max(), 1e-30))


@pytest.mark.parametrize("iteration, fade", [(0, 1.0), (1, 0.5)])
def test_gradient_penalty_matches_jax(iteration, fade):
    """The penalty and its gradients for the critic's parameters (a double
    backward through the critic), with alpha drawn from the JAX key."""
    res = RESOLUTIONS[iteration]
    real, fake = _volumes(10, 3, res), _volumes(11, 3, res)
    key = jax.random.PRNGKey(5)
    alpha = np.asarray(jax.random.uniform(key, (3, 1, 1, 1)))
    jax_params = _jax_critic_params()

    def jax_gp(params):
        critic = lambda x: JaxCritic().apply({"params": params}, x, iteration=iteration,
                                             fade_in_progress=fade)
        return jax_gradient_penalty(critic, key, jnp.asarray(real), jnp.asarray(fake))

    ref_gp, ref_grads = jax.value_and_grad(jax_gp)(jax_params)

    critic = _port_critic()
    params = dict(critic.named_parameters())
    gp = gradient_penalty(lambda x: critic(x, iteration, fade), torch.tensor(alpha),
                          torch.tensor(real), torch.tensor(fake))
    grads = torch.autograd.grad(gp, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
    assert abs(float(gp.detach()) - float(ref_gp)) <= GRAD_REL * abs(float(ref_gp))
    got = progressive_gan.params_to_jax(grads)
    for layer, leaves in ref_grads.items():
        for leaf, ref in leaves.items():
            if not np.abs(np.asarray(ref)).max():
                assert not got[layer][leaf].any(), (layer, leaf)  # a layer this iteration skips
                continue
            assert _rel(got[layer][leaf].numpy(), ref) <= GRAD_REL, (layer, leaf)


def test_rmsprop_matches_optax_three_steps():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = optax.rmsprop(1e-3)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jax_params)
    port = {k: torch.tensor(v) for k, v in params.items()}
    opt = RMSprop(port, 1e-3)
    for step in range(3):
        grads = {k: (rng.normal(size=v.shape) * 10.0 ** (step - 2)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        opt.step({k: torch.tensor(v) for k, v in grads.items()})
        for k in params:
            np.testing.assert_allclose(port[k].numpy(), np.asarray(jax_params[k]), atol=RMSPROP_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(state[0].nu[k]), rtol=1e-6)


@pytest.mark.parametrize("rescale", [False, True])
def test_synthetic_voxels_bit_identical(rescale):
    np.testing.assert_array_equal(make_voxel_dataset(3, 16, clamp=0.1, rescale=rescale, seed=5),
                                  jax_make_voxel_dataset(3, 16, clamp=0.1, rescale=rescale, seed=5))


def test_resident_batch_order_matches_jax():
    """The same batches, in the same order, for each (seed, epoch), with the
    remainder dropped."""
    data = np.arange(11 * 8, dtype=np.float32).reshape(11, 2, 2, 2)
    theirs = JaxResidentBatches(data, get_mesh(batch_size=4), 4, shuffle=True, drop_remainder=True,
                                seed=7)

    class Dataset:  # no .array: the port stacks the items
        def __len__(self):
            return len(data)

        def __getitem__(self, i):
            return data[i]

    for source in (Dataset(), type("A", (), {"array": data})()):
        ours = ResidentBatches(source, 4, seed=7, device="cpu")
        assert len(ours) == len(theirs) == 2
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got = [b.numpy() for b in ours]
            want = [np.asarray(jax.device_get(b)) for b in theirs]
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)

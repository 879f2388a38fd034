"""The port's progressive WGAN-GP trainer held against the JAX package's on
the CPU: one G step at iterations 0 and 1, from the same parameters and
latents (the D step is in test_torch_train_progressive.py).

Off a TPU the JAX trainer generates its volumes with float32 XLA, while the
port runs the bf16 plain versions of its kernels (B1 forward, B2 backward),
so the G step's gradients are compared by the bf16 rule of
tests/test_pallas_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.ops.coords import voxel_coordinates as jax_voxel_coordinates
from shapegan_tpu.train import hybrid_progressive_gan as jax_trainer
from shapegan_tpu_torch.models import progressive_gan
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer

BATCH = 2
LR = 1e-4
# nu = 0.1 g^2 after one step: relative agreement of the squared float32
# gradients, against the largest entry.
NU_REL = 1e-4


def _jax_models(seed=0):
    net, critic, g_params, d_params = jax_trainer.create_models(seed)
    return net, critic, jax.tree.map(np.asarray, g_params), jax.tree.map(np.asarray, d_params)


def _port_models(g_params, d_params):
    net = SDFNet(sdf_mlp.params_from_jax(g_params))
    critic = progressive_gan.ProgressiveDiscriminator()
    critic.load_state_dict(progressive_gan.params_from_jax(d_params))
    return net, critic


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("iteration, fade", [(0, 1.0), (1, 0.4)])
def test_g_step_grads_match_jax(iteration, fade):
    """The generator's gradients through B1/B2's plain versions against
    float32 truth, by the rule of tests/test_pallas_kernels.py: the port's
    error is within twice the XLA bf16 path's error plus 0.02. The float32
    truth is the JAX g_step's own gradient (its RMSprop nu = 0.1 g^2)."""
    res = jax_trainer.RESOLUTIONS[iteration]
    jnet, jcritic, g_params, d_params = _jax_models()
    tx = optax.rmsprop(LR)
    g_step, _ = jax_trainer.make_steps(jnet, jcritic, tx, tx, iteration, BATCH)
    rng = jax.random.PRNGKey(4)
    z = jax.random.normal(rng, (BATCH, 128))
    grid = jnp.asarray(jax_voxel_coordinates(res))
    _, g_state, _ = g_step(g_params, tx.init(g_params), d_params, rng, fade)

    def loss(dtype):
        def fn(params):
            fake = jax_mlp.apply_grid(params, grid, z, dtype=dtype).reshape((-1,) + (res,) * 3)
            return -jnp.mean(jcritic.apply({"params": d_params}, fake, iteration=iteration,
                                           fade_in_progress=fade))
        return fn

    truth = jax.grad(loss(jnp.float32))(g_params)
    bf16 = jax.grad(loss(jnp.bfloat16))(g_params)
    for key, value in truth.items():
        assert _rel(g_state[0].nu[key], 0.1 * np.asarray(value) ** 2) <= NU_REL, key

    net, critic = _port_models(g_params, d_params)
    grads, fake = trainer.generator_grads(net, critic, voxel_coordinates(res), torch.tensor(np.asarray(z)),
                                          iteration, fade)
    assert fake.shape == (BATCH, res, res, res)
    for key in sdf_mlp.PARAM_KEYS:
        t, b = np.asarray(truth[key]), np.asarray(bf16[key])
        scale = max(np.abs(t).max(), 1e-6)
        err_bf16 = np.abs(b - t).max() / scale
        err_port = np.abs(grads[key].numpy() - t).max() / scale
        assert err_port < 2.0 * err_bf16 + 0.02, (key, err_port, err_bf16)

"""The port's progressive WGAN-GP trainer held against the JAX package's on
the CPU: one D step at iterations 0 and 1, from the same parameters, batch
and noise (the G step is in test_torch_train_g_step.py, checkpoints and the
chain in test_torch_train_chain.py).

Off a TPU the JAX trainer generates its volumes with float32 XLA, while the
port runs the bf16 plain versions of its kernels. So the critic half (loss,
penalty, RMSprop) is compared given identical fakes, tightly in float32,
and the G step's gradients by the bf16 rule of tests/test_pallas_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu.ops.coords import voxel_coordinates as jax_voxel_coordinates
from shapegan_tpu.train import hybrid_gan as jax_hybrid_gan
from shapegan_tpu.train import hybrid_progressive_gan as jax_trainer
from shapegan_tpu_torch.models import progressive_gan
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer

BATCH = 2
LR = 1e-4
# One RMSprop step from nu = 0 moves each parameter by ~lr sqrt(10) sign(g);
# float32 summation order moves it by ~1e-8 where |g| is near 0.
PARAM_ATOL = 1e-7
# nu = 0.1 g^2 after one step: relative agreement of the squared gradients
# (float32, double backward through the critic), against the largest entry.
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
def test_d_step_matches_jax(iteration, fade):
    """The critic update from the same parameters, batch, latents and alpha
    (drawn from the JAX step's key), given the JAX step's own fakes."""
    res = jax_trainer.RESOLUTIONS[iteration]
    jnet, jcritic, g_params, d_params = _jax_models()
    tx = optax.rmsprop(LR)
    _, d_step = jax_trainer.make_steps(jnet, jcritic, tx, tx, iteration, BATCH)
    batch = np.random.default_rng(iteration).uniform(-0.1, 0.1, (BATCH,) + (res,) * 3).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    z_rng, gp_rng = jax.random.split(rng)
    z = np.asarray(jax.random.normal(z_rng, (BATCH, 128)))
    alpha = np.asarray(jax.random.uniform(gp_rng, (BATCH, 1, 1, 1)))
    fake = np.asarray(jax_hybrid_gan.generate_volumes_inference(
        jnet, g_params, jnp.asarray(jax_voxel_coordinates(res)), jnp.asarray(z), res))
    new_d, new_state, metrics = d_step(g_params, d_params, tx.init(d_params), jnp.asarray(batch),
                                       rng, fade)

    net, critic = _port_models(g_params, d_params)
    d_opt = RMSprop(dict(critic.named_parameters()), LR)
    grads, port_metrics = trainer.critic_grads(critic, torch.tensor(fake), torch.tensor(batch),
                                               torch.tensor(alpha), iteration, fade)
    d_opt.step(grads)
    for key in ("pred_fake", "pred_real", "gradient_penalty"):
        assert abs(float(port_metrics[key]) - float(metrics[key])) <= 1e-5 * max(
            1.0, abs(float(metrics[key]))), key
    got_params = progressive_gan.params_to_jax(dict(critic.named_parameters()))
    got_nu = progressive_gan.params_to_jax(d_opt.nu)
    for layer, leaves in new_d.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(got_params[layer][leaf].detach().numpy(), np.asarray(value),
                                       atol=PARAM_ATOL, rtol=0, err_msg=f"{layer}/{leaf}")
            assert _rel(got_nu[layer][leaf], new_state[0].nu[layer][leaf]) <= NU_REL, (layer, leaf)

    # The whole port step (its fakes from the bf16 plain grid kernel):
    # metrics within the bf16-vs-float32 distance of the volumes.
    net, critic = _port_models(g_params, d_params)
    _, port_d_step = trainer.make_steps(net, critic, RMSprop(net.param_dict(), LR),
                                        RMSprop(dict(critic.named_parameters()), LR), iteration)
    full = port_d_step(torch.tensor(batch), torch.tensor(z), torch.tensor(alpha), fade)
    for key in ("pred_fake", "pred_real", "gradient_penalty"):
        assert abs(float(full[key]) - float(metrics[key])) <= 1e-3 * max(1.0, abs(float(metrics[key])))

"""The port's hybrid GAN and hybrid WGAN trainers held against the JAX
package's on the CPU, part one: the voxel discriminator, its layout
converters, the weight clip and the BCE loss, and the G steps (recompute
and stash VJPs) from the same parameters and latents. The D steps,
checkpoints and entry points are in test_torch_hybrid_gan_train.py.

The voxel discriminator takes 32^3 volumes only (four convolutions down to
one score), so the steps run at 32^3 with a batch of 2. Off a TPU the JAX
trainers generate their volumes with float32 XLA while the port runs the
bf16 plain versions of its kernels, so the G steps' gradients are held
against float32 truth by the bf16 rule of tests/test_pallas_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu.models import gan as jax_gan_models
from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu.ops import losses as jax_losses
from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.ops.coords import voxel_coordinates as jax_voxel_coordinates
from shapegan_tpu.train import hybrid_gan as jax_gan
from shapegan_tpu.train import hybrid_wgan as jax_wgan
from shapegan_tpu_torch.models import gan
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.ops.losses import bce_loss
from shapegan_tpu_torch.train import hybrid_gan as trainer
from shapegan_tpu_torch.train import hybrid_wgan as wgan_trainer

BATCH = 2
RES = 32
# float32 convolutions on both sides: only summation order differs (read
# max 2.4e-7 on scores ~0.5 and ~0.05).
SCORE_ATOL = 1e-5
# The G loss's cotangent at the same fakes, against the largest entry
# (float32 on both sides).
D_REL = 1e-4
# The G step's fakes through the grid kernel's plain version (bf16) against
# the JAX step's float32 fakes (read max 4.3e-4 on values ~0.05; the bound of
# chip_smoke.py's bf16-vs-float32 checks).
FAKE_ATOL = 1e-3


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _port_disc(d_params, use_sigmoid=True):
    disc = gan.Discriminator(use_sigmoid)
    disc.load_state_dict(gan.params_from_jax(d_params))
    return disc


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


# ------------------------------------------------------- models and losses


@pytest.mark.parametrize("use_sigmoid", [True, False])
def test_discriminator_matches_flax(use_sigmoid):
    """The same parameters and volumes through flax's module and the port's,
    in float32."""
    jdisc = jax_gan_models.Discriminator(use_sigmoid=use_sigmoid)
    params = jax.tree.map(np.asarray, jdisc.init(jax.random.PRNGKey(3),
                                                 jnp.zeros((2,) + (RES,) * 3))["params"])
    x = _volumes(4) * 10
    want = np.asarray(jdisc.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_disc(params, use_sigmoid)(torch.tensor(x)).numpy()
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    if use_sigmoid:
        assert ((got > 0) & (got < 1)).all()


def test_discriminator_layout_and_init():
    """The converters round-trip flax's tree; the port's init draws every
    tensor from U(+-1/sqrt(fan_in)) in flax's shapes and names."""
    jdisc = jax_gan_models.Discriminator()
    tree = jax.tree.map(np.asarray, jdisc.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1,) + (RES,) * 3))["params"])
    back = gan.params_to_jax(gan.params_from_jax(tree))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b), back, tree)
    ours = gan.params_to_jax(dict(gan.Discriminator(generator=torch.Generator().manual_seed(1))
                                  .named_parameters()))
    assert set(ours) == set(tree) == {"conv0", "conv1", "conv2", "conv3"}
    for layer, leaves in tree.items():
        fan_in = int(np.prod(leaves["kernel"].shape[:-1]))
        for leaf, value in leaves.items():
            got = ours[layer][leaf].numpy()
            assert got.shape == value.shape, (layer, leaf)
            assert np.abs(got).max() <= 1 / np.sqrt(fan_in), (layer, leaf)
            if got.size > 1:
                assert got.std() > 0.3 / np.sqrt(fan_in), (layer, leaf)


def test_clip_parameters_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32) * 0.02,
            "b": rng.normal(size=(5,)).astype(np.float32) * 0.02}
    want = jax_gan_models.clip_parameters(tree, 0.01)
    given = {k: torch.tensor(v) for k, v in tree.items()}
    got = gan.clip_parameters(given, 0.01)
    for key in tree:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(given[key].numpy(), tree[key])  # a pure function


def test_bce_loss_matches_jax():
    """Values and gradients, with predictions at and past the clip's ends."""
    rng = np.random.default_rng(1)
    pred = np.concatenate([rng.uniform(0, 1, 30), [0.0, 1.0, 1e-9, 1 - 1e-9]]).astype(np.float32)
    for target in (np.zeros_like(pred), np.ones_like(pred), rng.uniform(0, 1, pred.shape)
                   .astype(np.float32)):
        value, grad = jax.value_and_grad(jax_losses.bce_loss)(jnp.asarray(pred), jnp.asarray(target))
        p = torch.tensor(pred, requires_grad=True)
        loss = bce_loss(p, torch.tensor(target))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(value), rtol=1e-6)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ steps


def _g_loss(kind, jdisc, d_params):
    """The JAX trainers' G loss of fake volumes [B, 32, 32, 32]."""
    def fn(fake):
        out = jdisc.apply({"params": d_params}, fake)
        return -jnp.mean(jnp.log(jnp.clip(out, 1e-7, 1.0))) if kind == "gan" else -jnp.mean(out)
    return fn


@functools.lru_cache(maxsize=None)
def _g_step_reference(kind):
    """(z, the float32 fakes) of the JAX trainer's G step; on the way, the
    loss that :func:`_g_loss` writes out is checked against the step's own
    Adam moment (mu = 0.1 g after one step)."""
    jnet, jdisc, g_params, d_params = _jax_models(kind)
    rng = jax.random.PRNGKey(4)
    z = jax.random.normal(rng, (BATCH, 128))
    grid = jnp.asarray(jax_voxel_coordinates(RES))
    tx = optax.adam(jax_gan.GENERATOR_LR if kind == "gan" else jax_wgan.LEARN_RATE)
    copy = jax.tree.map(jnp.array, g_params)
    if kind == "gan":
        g_step, _ = jax_gan.make_steps(jnet, jdisc, tx, batch_size=BATCH, resolution=RES)
        _, state, _ = g_step(copy, tx.init(copy), d_params, rng)
    else:
        _, generator_step = jax_wgan.make_steps(jnet, jdisc, tx, BATCH, resolution=RES)
        _, state, _, _ = generator_step(copy, tx.init(copy), d_params, rng)

    def volumes(params):
        return jax_mlp.apply_grid(params, grid, z).reshape((-1,) + (RES,) * 3)

    truth = jax.grad(lambda p: _g_loss(kind, jdisc, d_params)(volumes(p)))(g_params)
    for key, value in truth.items():
        assert _rel(state[0].mu[key], 0.1 * np.asarray(value)) <= 1e-4, key
    return np.asarray(z), np.asarray(volumes(g_params))


@pytest.mark.parametrize("stash", [None, (2, 4, 6)])
@pytest.mark.parametrize("kind", ["gan", "wgan"])
def test_g_step_grads_match_jax(kind, stash, monkeypatch):
    """The G step from the JAX step's parameters and latents, with the
    recompute VJP's plain versions (B1, B2) or the stash VJP's (B5a, B5b):
    its fakes within the bf16 distance of the JAX step's float32 fakes; the
    loss's cotangent at those fakes equal to the JAX critic's; and the
    generator's gradients against float32 truth for that cotangent, by the
    rule of tests/test_pallas_kernels.py (the port's error within twice the
    XLA bf16 path's plus 0.02). End to end, with each side's cotangent at
    its own fakes, b8 reads 0.028 against the rule's 0.0205 with either
    VJP: the sum of the cotangent moves 2.8 % with the fakes' mean bias of
    +3.6e-5 under the grid kernel's rounding points (XLA bf16's: -2.0e-5).
    The two VJPs are never held against each other: their relu masks differ
    by one bf16 rounding."""
    monkeypatch.setattr(trainer, "_GRID_STASH", stash)
    z, want_fake = _g_step_reference(kind)
    _, jdisc, g_params, d_params = _jax_models(kind)
    net = SDFNet(sdf_mlp.params_from_jax(g_params))
    disc = _port_disc(d_params, use_sigmoid=kind == "gan")
    grid = voxel_coordinates(RES)
    module = trainer if kind == "gan" else wgan_trainer
    grads, fake = module.generator_grads(net, disc, grid, torch.tensor(z), RES)[:2]
    assert fake.shape == (BATCH, RES, RES, RES)
    assert float((fake - torch.tensor(want_fake)).abs().max()) <= FAKE_ATOL

    volumes = fake.clone().requires_grad_(True)
    out = disc(volumes)
    loss = -torch.log(out.clamp(1e-7, 1.0)).mean() if kind == "gan" else -out.mean()
    (cot,) = torch.autograd.grad(loss, volumes)
    want_cot = jax.grad(_g_loss(kind, jdisc, d_params))(jnp.asarray(fake.numpy()))
    _check_rel(cot.numpy(), want_cot, D_REL)

    cot = jnp.asarray(cot.numpy().reshape(BATCH, -1))
    pts = jnp.asarray(jax_voxel_coordinates(RES))

    def vjp(dtype):
        _, back = jax.vjp(lambda p: jax_mlp.apply_grid(p, pts, jnp.asarray(z), dtype=dtype), g_params)
        return back(cot)[0]

    truth, bf16 = vjp(jnp.float32), vjp(jnp.bfloat16)
    for key in sdf_mlp.PARAM_KEYS:
        t, b = np.asarray(truth[key]), np.asarray(bf16[key])
        scale = max(np.abs(t).max(), 1e-6)
        err_bf16 = np.abs(b - t).max() / scale
        err_port = np.abs(grads[key].numpy() - t).max() / scale
        assert err_port < 2.0 * err_bf16 + 0.02, (key, err_port, err_bf16)


def _check_rel(got, want, bound):
    assert _rel(got, want) <= bound, _rel(got, want)

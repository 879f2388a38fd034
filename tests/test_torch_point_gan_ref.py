"""The port's point-GAN refinement trainer held against the JAX package's on
the CPU: the refinement forward (both evaluations and the spatial gradient,
float32 and bf16), the mixed batches' masks, the D-step and the G-step
(double backward) gradients and one RMSprop update each from the same
parameters, batch and noise, the checkpoints and the sidecar both ways, the
warm start from stage-1 files written by the JAX package, and a micro run
of the entry point with its resume."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.train import point_gan as jax_stage1
from shapegan_tpu.train import point_gan_ref as jax_trainer
from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.models import point_sdf_net as P
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.train import point_gan as stage1
from shapegan_tpu_torch.train import point_gan_ref as trainer

BATCH = 2
POINTS = 128
LR = 1e-4
# The refinement forward against the JAX one called as it is (eagerly, at
# flax's rounding points). float32, max |d| over the largest |ref| of each
# output: only summation orders differ, read <= 2.3e-6. bf16, ||d||_2 /
# ||ref||_2: the two packages round the same products to bf16 but sum the
# float32 terms in other orders, so a few activations land on the other side
# of a bf16 rounding and the flips spread, through the spatial gradient's
# backward most: read u_dist 1.0e-3, s_pos 3.3e-4, s_dist 7.6e-3, grad
# 1.25e-2. (Under jax.jit the CPU compiler keeps some bf16 products in
# float32, and the JAX function differs from itself by 1.45e-1 on grad.)
REFINE_F32_MAX_REL = 1e-5
REFINE_BF16_REL_L2 = 5e-2
# The steps' gradients as ||d||_2 / ||ref||_2 over all parameters, and the
# losses: the bounds of tests/test_torch_point_gan.py (D 1e-2, G 1e-4,
# 1e-4), which the refinement's steps read below (D 1.6e-3; G 5.4e-7).
D_GRAD_REL_L2 = 1e-2
G_GRAD_REL_L2 = 1e-4
LOSS_ATOL = 1e-4
# The parameter derivative of the moved points alone (sum(w * s_pos)), the
# double backward's own term, float32: read 1e-6; without the second-order
# term the same loss misses by O(1).
SECOND_ORDER_REL_L2 = 1e-4
# One RMSprop update from the same start. optax's first step is lr * g /
# (sqrt(0.1 g^2) + 1e-8), about lr / sqrt(0.1) * sign(g) for every element:
# an element whose gradient is noise on both sides takes either sign. So
# the updates are held by the share of elements that differ by more than a
# hundredth of a full step: read D 2.0e-4 (from the gradients above), G 0.
UPDATE_STEP_SHARE = 1e-2
UPDATE_SHARE = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_setup(seed=0):
    """Fresh JAX models whose generator's zero set crosses the unit cube: the
    head's bias moved by the median of the float32 generator's output on a
    probe cloud. (At init the output is ~0.5 everywhere, no point is near
    the surface, and the mixed batches mask the whole surface half.)"""
    generator, critic, g_params, d_params = jax_stage1.create_models(seed)
    g_params, d_params = jax.tree.map(np.array, g_params), jax.tree.map(np.asarray, d_params)
    probe = np.random.default_rng(seed).uniform(-1, 1, (1, 1024, 3)).astype(np.float32)
    out = generator.clone(dtype=jnp.float32).apply({"params": g_params}, probe, jnp.zeros((1, 128)))
    g_params["lin7"]["bias"] = g_params["lin7"]["bias"] - np.float32(np.median(np.asarray(out)))
    return generator, critic, g_params, d_params


def _port_models(g_params, d_params, dtype=torch.bfloat16):
    generator, critic = stage1.create_models(dtype=dtype)
    generator.load_state_dict(P.params_from_jax(g_params))
    critic.load_state_dict(P.params_from_jax(d_params))
    return generator, critic


def _cloud(seed=1):
    """A real cloud: uniform points in the unit cube with distances to a
    sphere of radius 0.5, and surface points near it."""
    rng = np.random.default_rng(seed)
    u_pos = rng.uniform(-1, 1, (BATCH, POINTS, 3)).astype(np.float32)
    u_dist = (np.linalg.norm(u_pos, axis=-1, keepdims=True) - 0.5).astype(np.float32)
    s_pos = (u_pos / np.linalg.norm(u_pos, axis=-1, keepdims=True) * 0.5
             + rng.normal(0, 0.01, u_pos.shape)).astype(np.float32)
    s_dist = (np.linalg.norm(s_pos, axis=-1, keepdims=True) - 0.5).astype(np.float32)
    return u_pos, u_dist, s_pos, s_dist


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


def _port_flat(tensors):
    return _flat(P.params_to_jax(tensors))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def t(a):
    return torch.tensor(np.asarray(a))


def _d_noise(key):
    """The JAX d_step's draws from its key (its own split), as the port's
    noise dict."""
    z_rng, ref_rng, mix1, mix2, gp_rng = jax.random.split(key, 5)
    return {"z": jax.random.normal(z_rng, (BATCH, trainer.LATENT_SIZE)),
            "jitter": jax.random.normal(ref_rng, (BATCH, POINTS, 3)),
            "keep_fake": jax.random.uniform(mix1, (BATCH, POINTS)),
            "keep_real": jax.random.uniform(mix2, (BATCH, POINTS)),
            "alpha": jax.random.uniform(gp_rng, (BATCH, 1, 1))}, (z_rng, ref_rng, mix1, mix2, gp_rng)


def _g_noise(key):
    z_rng, ref_rng, mix_rng = jax.random.split(key, 3)
    return {"z": jax.random.normal(z_rng, (BATCH, trainer.LATENT_SIZE)),
            "jitter": jax.random.normal(ref_rng, (BATCH, POINTS, 3)),
            "keep": jax.random.uniform(mix_rng, (BATCH, POINTS))}, (z_rng, ref_rng, mix_rng)


# ------------------------------------------------------------- the forward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refine_matches_jax(dtype):
    """Both evaluations, the spatial gradient and the moved points, with the
    jitter drawn from the JAX refine's own key and handed to the port."""
    jgen, _, g_params, d_params = _jax_setup(seed=2)
    jgen = jgen.clone(dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    u_pos = _cloud()[0]
    z = jax.random.normal(jax.random.PRNGKey(3), (BATCH, trainer.LATENT_SIZE))
    key = jax.random.PRNGKey(4)
    want = jax_trainer.refine(jgen, g_params, jnp.asarray(u_pos), z, key)
    want_grad = jax.grad(lambda p: jnp.sum(jgen.apply({"params": g_params}, p, z)))(u_pos)
    jitter = jax.random.normal(key, (BATCH, POINTS, 3))

    generator, _ = _port_models(g_params, d_params, getattr(torch, dtype))
    got = trainer.refine(generator, t(u_pos), t(z), t(jitter))
    pos = t(u_pos).requires_grad_(True)
    (got_grad,) = torch.autograd.grad(generator(pos, t(z)).sum(), pos)
    for name, a, b in zip(("u_pos", "u_dist", "s_pos", "s_dist", "grad"),
                          (*got, got_grad), (*want, want_grad)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float32, name
        if dtype == "float32":
            rel, bound = float(np.abs(a - b).max() / np.abs(b).max()), REFINE_F32_MAX_REL
        else:
            rel, bound = _rel_l2(a.astype(np.float64), b.astype(np.float64)), REFINE_BF16_REL_L2
        print(f"{dtype} {name}: {rel:.3e} (<= {bound})")
        assert rel <= bound, (name, rel)


def test_mixed_batch_masks_bit_equal():
    """Given the same keep uniforms, the port's positions, distances and
    masks are the JAX ones exactly."""
    u_pos, u_dist, s_pos, s_dist = _cloud(seed=5)
    key = jax.random.PRNGKey(6)
    want = jax_trainer.mixed_batch(u_pos, u_dist, s_pos, s_dist, key)
    keep = jax.random.uniform(key, (BATCH, POINTS))
    got = trainer.mixed_batch(t(u_pos), t(u_dist), t(s_pos), t(s_dist), t(keep))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mask = got[2].numpy()
    assert mask.shape == (BATCH, 2 * POINTS) and 0 < mask[:, :POINTS].mean() < 1
    np.testing.assert_array_equal(mask[:, POINTS:], np.abs(u_dist[..., 0]) < trainer.THRESHOLD)


# ------------------------------------------------------------------- steps


def _jax_critic_loss(critic, real, fake, noise):
    """The JAX trainer's D loss (train/point_gan_ref.py, d_step's loss_fn)
    on given clouds and draws."""
    real_pos, real_dist, real_mask = _jax_mixed(*real, noise["keep_real"])
    fake_pos, fake_dist, fake_mask = _jax_mixed(*fake, noise["keep_fake"])
    u_pos, u_dist, fake_u_dist = real[0], real[1], fake[1]

    def loss_fn(d_params):
        out_real = critic.apply({"params": d_params}, real_pos, real_dist, mask=real_mask)[..., 0]
        out_fake = critic.apply({"params": d_params}, fake_pos, fake_dist, mask=fake_mask)[..., 0]
        d_loss = jnp.mean(out_fake) - jnp.mean(out_real)
        crit = lambda dist: critic.apply({"params": d_params}, u_pos, dist)[..., 0]
        interp = noise["alpha"] * u_dist + (1.0 - noise["alpha"]) * fake_u_dist
        grads = jax.grad(lambda d: jnp.sum(crit(d)))(interp)
        norms = jnp.sqrt(jnp.sum(grads**2, axis=(1, 2)) + 1e-12)
        gp = jax_trainer.GRADIENT_PENALTY * jnp.mean((norms - 1.0) ** 2)
        return d_loss + gp, (d_loss, gp)

    return loss_fn


def _jax_mixed(u_pos, u_dist, s_pos, s_dist, keep):
    """jax_trainer.mixed_batch with given keep uniforms instead of a key."""
    near = jnp.abs(u_dist[..., 0]) < jax_trainer.THRESHOLD
    return (jnp.concatenate([u_pos, s_pos], axis=1), jnp.concatenate([u_dist, s_dist], axis=1),
            jnp.concatenate([near | (keep < jax_trainer.RANDOM_KEEP), near], axis=1))


def test_d_step_gradients_and_update_match_jax():
    """The critic's gradients from the same parameters, real cloud, fake
    cloud (the JAX bf16 refine's) and draws from the JAX step's own key
    split; then the port's whole d_step (its fake from the bf16 module, as
    on the CPU the JAX step's) against the JAX d_step: losses and one
    RMSprop update."""
    jgen, jcritic, g_params, d_params = _jax_setup(seed=7)
    real = _cloud(seed=8)
    key = jax.random.PRNGKey(9)
    noise, (z_rng, ref_rng, *_rest) = _d_noise(key)
    fake = jax.jit(lambda p: jax_trainer.refine(jgen, p, real[0], noise["z"], ref_rng))(g_params)
    fake = jax.tree.map(np.asarray, fake)
    (_, (d_loss, gp)), want = jax.jit(jax.value_and_grad(
        _jax_critic_loss(jcritic, real, fake, noise), has_aux=True))(d_params)

    generator, critic = _port_models(g_params, d_params)
    port_noise = {k: t(v) for k, v in noise.items()}
    grads, metrics = trainer.critic_grads(critic, tuple(map(t, real)), tuple(map(t, fake)),
                                          port_noise["keep_real"], port_noise["keep_fake"],
                                          port_noise["alpha"])
    rel = _rel_l2(_port_flat(grads), _flat(want))
    print(f"D-step gradients: rel L2 {rel:.3e}; d_loss {float(metrics['d_loss']):.6f} vs "
          f"{float(d_loss):.6f}, gp {float(metrics['gradient_penalty']):.6f} vs {float(gp):.6f}")
    assert rel <= D_GRAD_REL_L2
    assert abs(float(metrics["d_loss"]) - float(d_loss)) <= LOSS_ATOL
    assert abs(float(metrics["gradient_penalty"]) - float(gp)) <= LOSS_ATOL * max(1.0, float(gp))

    # One RMSprop update from these gradients, against optax's on the JAX ones.
    tx = optax.rmsprop(LR)
    updates, _ = tx.update(want, tx.init(d_params), d_params)
    d_opt = RMSprop(dict(critic.named_parameters()), LR)
    before = _port_flat(dict(critic.named_parameters()))
    d_opt.step(grads)
    _check_update("D step", _port_flat(dict(critic.named_parameters())) - before, _flat(updates))

    # The whole step on each side, each with its own bf16 fake cloud.
    d_step, _ = jax_trainer.make_steps(jgen, jcritic, tx, tx)
    _, _, jax_loss, _ = d_step(g_params, jax.tree.map(jnp.asarray, d_params), tx.init(d_params),
                               *real, key)
    generator, critic = _port_models(g_params, d_params)
    port_d_step, _ = trainer.make_steps(generator, critic,
                                        RMSprop(dict(generator.named_parameters()), LR),
                                        RMSprop(dict(critic.named_parameters()), LR))
    before = {k: v.detach().clone() for k, v in critic.named_parameters()}
    full = port_d_step(tuple(map(t, real)), port_noise)
    print(f"D step: d_loss {float(full['d_loss']):.6f} vs {float(jax_loss):.6f}")
    assert abs(float(full["d_loss"]) - float(jax_loss)) <= LOSS_ATOL
    # The update moved the critic (Dense_6's bias has no gradient: it
    # cancels in the loss and the penalty).
    moved = {k: not torch.equal(v, before[k]) for k, v in critic.named_parameters()}
    assert moved.pop("Dense_6.bias") is False and all(moved.values())


def test_g_step_double_backward_matches_jax():
    """The generator's gradients through its own spatial gradient (float32
    generator, bf16 critic) against jax.value_and_grad of the JAX G loss,
    from the same draws; then one RMSprop update against the JAX g_step's."""
    jgen, jcritic, g_params, d_params = _jax_setup(seed=10)
    jgen32 = jgen.clone(dtype=jnp.float32)
    u_pos = _cloud(seed=11)[0]
    key = jax.random.PRNGKey(12)
    noise, (z_rng, ref_rng, mix_rng) = _g_noise(key)

    def loss_fn(gp_):
        fake = jax_trainer.refine(jgen32, gp_, u_pos, noise["z"], ref_rng)
        pos, dist, mask = jax_trainer.mixed_batch(*fake, mix_rng)
        return -jnp.mean(jcritic.apply({"params": d_params}, pos, dist, mask=mask)[..., 0])

    loss, want = jax.jit(jax.value_and_grad(loss_fn))(g_params)
    generator, critic = _port_models(g_params, d_params)
    port_noise = {k: t(v) for k, v in noise.items()}
    grads, port_loss = trainer.generator_grads(generator, critic, t(u_pos), port_noise["z"],
                                               port_noise["jitter"], port_noise["keep"])
    rel = _rel_l2(_port_flat(grads), _flat(want))
    print(f"G-step gradients: rel L2 {rel:.3e}; loss {float(port_loss):.6f} vs {float(loss):.6f}")
    assert set(grads) == set(dict(generator.named_parameters()))
    assert rel <= G_GRAD_REL_L2
    assert abs(float(port_loss) - float(loss)) <= LOSS_ATOL

    # The moved points' own parameter derivative, d sum(w * s_pos) / d
    # params, where the double backward's term is of the order of the whole.
    w = np.random.default_rng(15).normal(size=u_pos.shape).astype(np.float32)
    want_s = jax.jit(jax.grad(lambda gp_: jnp.sum(w * jax_trainer.refine(
        jgen32, gp_, u_pos, noise["z"], ref_rng)[2])))(g_params)
    names, params = zip(*generator.named_parameters())
    s_pos = trainer.refine(generator, t(u_pos), port_noise["z"], port_noise["jitter"],
                           dtype=torch.float32, create_graph=True)[2]
    rel = _rel_l2(_port_flat(dict(zip(names, torch.autograd.grad((t(w) * s_pos).sum(), params)))),
                  _flat(want_s))
    # The same with the spatial gradient held constant: the second-order
    # term missing, as behind an autograd.Function without a double backward.
    pos = t(u_pos).requires_grad_(True)
    u_dist = generator(pos, port_noise["z"], dtype=torch.float32)
    (grad,) = torch.autograd.grad(u_dist.sum(), pos, retain_graph=True)
    s_pos = t(u_pos) - u_dist * grad + trainer.JITTER * port_noise["jitter"]
    first = _rel_l2(_port_flat(dict(zip(names, torch.autograd.grad((t(w) * s_pos).sum(), params)))),
                    _flat(want_s))
    print(f"d sum(w * s_pos) / d params: rel L2 {rel:.3e} (first order only: {first:.3e})")
    assert rel <= SECOND_ORDER_REL_L2 and first > 0.1

    tx = optax.rmsprop(LR)
    _, g_step = jax_trainer.make_steps(jgen, jcritic, tx, tx)
    new_params, _, _ = g_step(jax.tree.map(jnp.asarray, g_params), tx.init(g_params),
                              jax.tree.map(jnp.asarray, d_params), u_pos, key)
    g_opt = RMSprop(dict(generator.named_parameters()), LR)
    _, port_g_step = trainer.make_steps(generator, critic, g_opt,
                                        RMSprop(dict(critic.named_parameters()), LR))
    before = _port_flat(dict(generator.named_parameters()))
    port_g_step(t(u_pos), port_noise)
    _check_update("G step", _port_flat(dict(generator.named_parameters())) - before,
                  _flat(new_params) - _flat(g_params))


def _check_update(name, got, want):
    step = LR / np.sqrt(0.1)
    share = float((np.abs(got - want) > UPDATE_STEP_SHARE * step).mean())
    print(f"{name}: the update differs by more than {UPDATE_STEP_SHARE} of a step on {share:.2e} "
          f"of the elements")
    assert share <= UPDATE_SHARE


# ------------------------------------------------------ checkpoints and runs


def test_checkpoints_load_both_ways_and_warm_start(tmp_path):
    """JAX-saved stage-1 files warm-start the port's models; JAX-saved
    refinement files and the optax sidecar load into the port with
    ``continue`` (and win over stage 1); the port's files load into the
    JAX package's templates, strictly."""
    jgen, jcritic, g_params, d_params = _jax_setup(seed=13)
    base = str(tmp_path / "jax")
    jax_checkpoints.save(g_params, trainer.STAGE1_G_NAME, base=base)
    jax_checkpoints.save(d_params, trainer.STAGE1_D_NAME, base=base)
    generator, critic = stage1.create_models(seed=5)
    assert trainer.restore_models(generator, critic, base, resume=True) == [
        trainer.STAGE1_G_NAME, trainer.STAGE1_D_NAME]
    for module, tree in ((generator, g_params), (critic, d_params)):
        got = P.params_to_jax(dict(module.named_parameters()))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), got, tree)

    tx = optax.rmsprop(LR)
    d_step, _ = jax_trainer.make_steps(jgen, jcritic, tx, tx)
    ref_d, d_state, _, _ = d_step(g_params, jax.tree.map(jnp.asarray, d_params), tx.init(d_params),
                                  *_cloud(seed=14), jax.random.PRNGKey(0))
    ref_g = jax.tree.map(lambda x: x * 1.5, g_params)
    jax_checkpoints.save(ref_g, trainer.G_NAME, base=base)
    jax_checkpoints.save(ref_d, trainer.D_NAME, base=base)
    jax_checkpoints.save({"g": tx.init(g_params), "d": d_state}, trainer.OPT_NAME, base=base)
    result = trainer.train(parse_cli(["cpu", "continue", "synthetic=2", "epochs=1",
                                      f"model_dir={base}", f"plot_dir={tmp_path}/plots"]),
                           curriculum=[(64, 4, 1)])  # the stage is skipped: 2 shapes < 4
    assert result["steps"] == 0
    assert result["loaded"] == [trainer.STAGE1_G_NAME, trainer.STAGE1_D_NAME, trainer.G_NAME,
                                trainer.D_NAME, trainer.OPT_NAME]
    for module, tree in ((result["generator"], ref_g), (result["discriminator"], ref_d)):
        got = P.params_to_jax(dict(module.named_parameters()))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), got, tree)

    generator, critic = result["generator"], result["discriminator"]
    g_opt = RMSprop(dict(generator.named_parameters()), LR)
    d_opt = RMSprop(dict(critic.named_parameters()), LR)
    stage1._load_optimizers(g_opt, d_opt, base, trainer.OPT_NAME)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 P.params_to_jax(d_opt.nu), d_state[0].nu)
    port_base = str(tmp_path / "port")
    checkpoints.save(P.params_to_jax(dict(generator.named_parameters())), trainer.G_NAME,
                     base=port_base)
    checkpoints.save(P.params_to_jax(dict(critic.named_parameters())), trainer.D_NAME, base=port_base)
    checkpoints.save(stage1._optimizer_tree(g_opt, d_opt), trainer.OPT_NAME, base=port_base)
    g_back = jax_checkpoints.load(g_params, trainer.G_NAME, base=port_base, strict=True)
    d_back = jax_checkpoints.load(d_params, trainer.D_NAME, base=port_base, strict=True)
    opt_back = jax_checkpoints.load({"g": tx.init(g_params), "d": d_state}, trainer.OPT_NAME,
                                    base=port_base, strict=True)
    for back, tree in ((g_back, ref_g), (d_back, ref_d), (opt_back["d"][0].nu, d_state[0].nu)):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                     back, tree)


# A micro curriculum: 4 shapes of 64 points, batch 2 (2 steps an epoch, the
# G step at global step 5), then a stage no dataset of 4 shapes fills.
MICRO = [(64, 2, 3), (96, 8, 2)]


def _run(root, *argv):
    config = parse_cli(["cpu", "synthetic=4", f"model_dir={root}/models", f"plot_dir={root}/plots",
                        *argv])
    return trainer.train(config, curriculum=MICRO)


def test_entry_point_micro_run_and_resume(tmp_path):
    """Three epochs straight equal one epoch and a ``continue`` to three
    (across the G step at step 5): the same parameters and moments bit for
    bit, the same CSV epochs; both warm-started from stage-1 files."""
    g, d = stage1.create_models(seed=9)
    for kind in ("straight", "resumed"):
        base = str(tmp_path / kind / "models")
        checkpoints.save(P.params_to_jax(dict(g.named_parameters())), trainer.STAGE1_G_NAME, base=base)
        checkpoints.save(P.params_to_jax(dict(d.named_parameters())), trainer.STAGE1_D_NAME, base=base)
    straight = _run(tmp_path / "straight", "epochs=3")
    first = _run(tmp_path / "resumed", "epochs=1")
    resumed = _run(tmp_path / "resumed", "epochs=3", "continue")
    assert (straight["steps"], first["steps"], resumed["steps"]) == (6, 2, 4)
    assert (len(straight["g_step_s"]), len(first["g_step_s"]), len(resumed["g_step_s"])) == (1, 0, 1)
    assert straight["loaded"] == first["loaded"] == [trainer.STAGE1_G_NAME, trainer.STAGE1_D_NAME]
    assert resumed["loaded"][2:] == [trainer.G_NAME, trainer.D_NAME, trainer.OPT_NAME]
    for name in ("generator", "discriminator"):
        a = straight[name].state_dict()
        b = resumed[name].state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    for kind in ("straight", "resumed"):
        with open(tmp_path / kind / "plots" / "point_gan_ref_training.csv") as f:
            rows = [line.split() for line in f]
        assert [(r[0], r[1]) for r in rows] == [("64", "1"), ("64", "2"), ("64", "3")], rows
        assert all(np.isfinite(float(r[3])) for r in rows)
        for name in (trainer.G_NAME, trainer.D_NAME, trainer.OPT_NAME):
            assert checkpoints.exists(name, base=str(tmp_path / kind / "models"))
    with np.load(checkpoints.get_filename(trainer.OPT_NAME, base=str(tmp_path / "straight" / "models"))) as a, \
            np.load(checkpoints.get_filename(trainer.OPT_NAME, base=str(tmp_path / "resumed" / "models"))) as b:
        assert set(a.files) == set(b.files) and "g/0/nu/lin4/kernel" in a.files
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_entry_point_needs_cuda_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.train(parse_cli(["synthetic=4", f"model_dir={tmp_path}/m", f"plot_dir={tmp_path}/p"]),
                      curriculum=MICRO)


def test_step_noise_is_keyed_by_the_step():
    noise = torch.Generator()
    a = trainer.step_noise(noise, 0, 7, 3, 10, "cpu")
    trainer.step_noise(noise, 0, 8, 3, 10, "cpu")
    b = trainer.step_noise(noise, 0, 7, 3, 10, "cpu")
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    d, g = a
    assert d["jitter"].shape == (3, 10, 3) and d["alpha"].shape == (3, 1, 1)
    assert d["keep_real"].shape == g["keep"].shape == (3, 10)
    assert not torch.equal(d["z"], g["z"])

"""The port's point-GAN trainer held against the JAX package's on the CPU:
the point datasets and the loader's batch order, the D-step and G-step
gradients from the same parameters, batch and noise, the bf16 split's
fidelity to float32, checkpoints both ways, and a micro run of the entry
point with its resume."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.data import datasets as jax_datasets
from shapegan_tpu.data import synthetic as jax_synthetic
from shapegan_tpu.ops.point_gen_pallas import generate_best as jax_generate_best
from shapegan_tpu.train import point_gan as jax_trainer
from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.data import datasets, synthetic
from shapegan_tpu_torch.models import point_sdf_net as P
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.train import point_gan as trainer

BATCH = 4
POINTS = 256
LR = 1e-4
# Gradients of the port's steps against the JAX steps', as ||d||_2 / ||ref||_2
# over all parameters. The critic runs in bf16 in both, so products summed in
# another order flip bf16 roundings now and then, and the D step's double
# backward (the penalty) spreads the flips: read 2.6e-3. The G step's single
# backward through the same critic reads 2.7e-7.
D_GRAD_REL_L2 = 1e-2
G_GRAD_REL_L2 = 1e-4
# The losses and the penalty: float32 sums of bf16 critic scores.
LOSS_ATOL = 1e-4
# The bf16 split against an all-float32 step (the JAX package's
# test_bf16_compute_grads_track_fp32 criterion).
BF16_GRAD_COSINE = 0.97


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores, and PyTorch's default of a thread per core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_setup(seed=0):
    generator, critic, g_params, d_params = jax_trainer.create_models(seed)
    return generator, critic, jax.tree.map(np.asarray, g_params), jax.tree.map(np.asarray, d_params)


def _port_models(g_params, d_params, dtype=torch.bfloat16):
    generator, critic = trainer.create_models(dtype=dtype)
    generator.load_state_dict(P.params_from_jax(g_params))
    critic.load_state_dict(P.params_from_jax(d_params))
    return generator, critic


def _batch(seed=1):
    u = np.random.default_rng(seed).uniform(-1, 1, (BATCH, POINTS, 4)).astype(np.float32)
    u[..., 3] *= 0.1
    return u[..., :3], u[..., 3:]


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


def _port_flat(grads):
    return _flat(P.params_to_jax(grads))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ------------------------------------------------------------------- data


def test_synthetic_point_dataset_is_bit_identical():
    ours = synthetic.SyntheticPointDataset(3, pool_size=512, num_points=300, seed=5)
    theirs = jax_synthetic.SyntheticPointDataset(3, pool_size=512, num_points=300, seed=5)
    assert len(ours) == len(theirs) == 3
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for idx in range(3):
            for a, b in zip(ours[idx], theirs[idx]):
                assert a.dtype == np.float32 and a.shape == (300, 4)
                np.testing.assert_array_equal(a, b)


def _write_point_files(root, names, counts):
    rng = np.random.default_rng(0)
    for kind in ("uniform", "surface"):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
    for name, (n_uniform, n_surface) in zip(names, counts):
        np.save(os.path.join(root, "uniform", f"{name}.npy"), rng.normal(size=(n_uniform, 4)))
        np.save(os.path.join(root, "surface", f"{name}.npy"), rng.normal(size=(n_surface, 4)))
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def test_point_dataset_matches_jax(tmp_path):
    """An on-disk fixture: equal counts share one index draw, unequal ones
    draw the surface indices apart; float32 out; keyed by (seed, epoch, idx)."""
    root = str(tmp_path / "chairs")
    _write_point_files(root, ["a", "b", "c"], [(500, 500), (400, 700), (64, 64)])
    ours = datasets.PointDataset.from_split(root, "train", num_points=128, seed=3)
    theirs = jax_datasets.PointDataset.from_split(root, "train", num_points=128, seed=3)
    assert len(ours) == 3
    for epoch in (0, 4):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for idx in range(3):
            for a, b in zip(ours[idx], theirs[idx]):
                assert a.dtype == np.float32 and a.shape == (128, 4)
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        datasets.PointDataset(root, ["a"], num_points=0)


def test_batch_loader_order_matches_jax():
    """Tuple items, drop_remainder, set_epoch and iteration without it."""
    ours_ds = synthetic.SyntheticPointDataset(7, pool_size=64, num_points=16, seed=2)
    theirs_ds = jax_synthetic.SyntheticPointDataset(7, pool_size=64, num_points=16, seed=2)
    ours = datasets.BatchLoader(ours_ds, 3, shuffle=True, drop_remainder=True, seed=9,
                                num_workers=2, prefetch=1)
    theirs = jax_datasets.BatchLoader(theirs_ds, 3, shuffle=True, drop_remainder=True, seed=9,
                                      num_workers=2, prefetch=1, backend="thread")
    assert len(ours) == len(theirs) == 2
    for epoch in (5, None, None, 6):
        if epoch is not None:
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for (gu, gs), (wu, ws) in zip(got, want):
            assert gu.shape == (3, 16, 4)
            np.testing.assert_array_equal(gu, wu)
            np.testing.assert_array_equal(gs, ws)
    whole = datasets.BatchLoader(ours_ds, 3, shuffle=False, seed=None)
    assert [b[0].shape[0] for b in whole] == [3, 3, 1]


# ------------------------------------------------------------------ steps


def _jax_critic_loss(critic, u_pos, u_dist, fake, alpha):
    """The JAX trainer's D loss (train/point_gan.py, d_step's loss_fn)."""

    def loss_fn(d_params):
        crit = lambda dist: critic.apply({"params": d_params}, u_pos, dist)[..., 0]
        d_loss = jnp.mean(crit(fake)) - jnp.mean(crit(u_dist))
        interp = alpha * u_dist + (1.0 - alpha) * fake
        grads = jax.grad(lambda d: jnp.sum(crit(d)))(interp)
        norms = jnp.sqrt(jnp.sum(grads**2, axis=(1, 2)) + 1e-12)
        gp = jax_trainer.GRADIENT_PENALTY * jnp.mean((norms - 1.0) ** 2)
        return d_loss + gp, (d_loss, gp)

    return loss_fn


def test_d_step_gradients_match_jax():
    """The critic's gradients from the same parameters, batch, fake cloud,
    and penalty coefficients drawn from the JAX step's own key split; then
    the port's whole d_step (its fake from the bf16 module, as on the CPU
    the JAX step's) within the bf16 distance of the JAX step's losses."""
    jgen, jcritic, g_params, d_params = _jax_setup()
    u_pos, u_dist = _batch()
    z_rng, gp_rng = jax.random.split(jax.random.PRNGKey(7))
    z = jax.random.normal(z_rng, (BATCH, trainer.LATENT_SIZE))
    alpha = jax.random.uniform(gp_rng, (BATCH, 1, 1))
    fake = jax_generate_best(jgen, g_params, u_pos, z)
    (_, (d_loss, gp)), want = jax.jit(jax.value_and_grad(
        _jax_critic_loss(jcritic, u_pos, u_dist, fake, alpha), has_aux=True))(d_params)

    generator, critic = _port_models(g_params, d_params)
    t = lambda a: torch.tensor(np.asarray(a))
    grads, metrics = trainer.critic_grads(critic, t(u_pos), t(u_dist), t(fake), t(alpha))
    rel = _rel_l2(_port_flat(grads), _flat(want))
    print(f"D-step gradients: rel L2 {rel:.3e}; d_loss {float(metrics['d_loss']):.6f} vs "
          f"{float(d_loss):.6f}, gp {float(metrics['gradient_penalty']):.6f} vs {float(gp):.6f}")
    assert rel <= D_GRAD_REL_L2
    assert abs(float(metrics["d_loss"]) - float(d_loss)) <= LOSS_ATOL
    assert abs(float(metrics["gradient_penalty"]) - float(gp)) <= LOSS_ATOL * max(1.0, float(gp))

    d_opt = RMSprop(dict(critic.named_parameters()), LR)
    d_step, _ = trainer.make_steps(generator, critic, RMSprop(dict(generator.named_parameters()), LR),
                                   d_opt)
    before = {k: v.detach().clone() for k, v in critic.named_parameters()}
    full = d_step(t(u_pos), t(u_dist), t(z), t(alpha))
    # Its fake cloud from the bf16 module, as the JAX step's off a TPU:
    # d_loss reads 3.05e-5 from the JAX step's (one step of the bf16 scores).
    assert abs(float(full["d_loss"]) - float(d_loss)) <= LOSS_ATOL
    # the update moved the critic (Dense_6's bias has no gradient: it cancels
    # in the loss and the penalty)
    moved = {k: not torch.equal(v, before[k]) for k, v in critic.named_parameters()}
    assert moved.pop("Dense_6.bias") is False and all(moved.values())


def test_g_step_gradients_match_jax():
    """The generator's gradients (float32 generator through the bf16 critic)
    from the same parameters, batch and latents drawn from the JAX step's
    key."""
    jgen, jcritic, g_params, d_params = _jax_setup(seed=1)
    jgen32 = jgen.clone(dtype=jnp.float32)
    u_pos, _ = _batch(seed=2)
    z = jax.random.normal(jax.random.PRNGKey(8), (BATCH, trainer.LATENT_SIZE))

    def loss_fn(gp_):
        fake = jgen32.apply({"params": gp_}, u_pos, z)
        return -jnp.mean(jcritic.apply({"params": d_params}, u_pos, fake)[..., 0])

    loss, want = jax.jit(jax.value_and_grad(loss_fn))(g_params)
    generator, critic = _port_models(g_params, d_params)
    grads, port_loss = trainer.generator_grads(generator, critic, torch.tensor(u_pos),
                                               torch.tensor(np.asarray(z)))
    rel = _rel_l2(_port_flat(grads), _flat(want))
    print(f"G-step gradients: rel L2 {rel:.3e}; loss {float(port_loss):.6f} vs {float(loss):.6f}")
    assert rel <= G_GRAD_REL_L2
    assert abs(float(port_loss) - float(loss)) <= LOSS_ATOL
    assert set(grads) == set(dict(generator.named_parameters()))


def test_bf16_compute_grads_track_fp32():
    """The trainer's mixed precision against all-float32 steps, in the port
    alone: the bf16 critic's D-step gradients with the fake cloud held fixed,
    and the G step's (float32 generator through the bf16 critic), by cosine;
    the bf16 fake cloud is the float32 one within 5 % of its scale."""
    gen16, crit16 = trainer.create_models(seed=0, dtype=torch.bfloat16)
    gen32, crit32 = trainer.create_models(seed=0, dtype=torch.float32)
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.uniform(-1, 1, (BATCH, POINTS, 4)).astype(np.float32))
    u_pos, u_dist = u[..., :3], u[..., 3:]
    z = torch.tensor(rng.normal(size=(BATCH, trainer.LATENT_SIZE)).astype(np.float32))
    alpha = torch.tensor(rng.uniform(size=(BATCH, 1, 1)).astype(np.float32))
    with torch.no_grad():
        fake16, fake = gen16(u_pos, z), gen32(u_pos, z)
    assert float((fake16 - fake).abs().max()) < 0.05 * float(fake.abs().max())

    def flat(grads):
        return torch.cat([g.double().flatten() for g in grads.values()]).numpy()

    d16 = flat(trainer.critic_grads(crit16, u_pos, u_dist, fake, alpha)[0])
    d32 = flat(trainer.critic_grads(crit32, u_pos, u_dist, fake, alpha)[0])
    g16 = flat(trainer.generator_grads(gen16, crit16, u_pos, z)[0])
    g32 = flat(trainer.generator_grads(gen32, crit32, u_pos, z)[0])
    d_cos, g_cos = _cosine(d16, d32), _cosine(g16, g32)
    print(f"cosine: D step {d_cos:.4f}, G step {g_cos:.4f}")
    assert d_cos > BF16_GRAD_COSINE and g_cos > BF16_GRAD_COSINE


# ------------------------------------------------------ checkpoints and runs


def test_checkpoints_load_both_ways(tmp_path):
    """JAX-saved G, D and the optax sidecar load into the port's trainer;
    the port's files load into the JAX package's templates, strictly."""
    jgen, jcritic, g_params, d_params = _jax_setup(seed=3)
    tx = optax.rmsprop(LR)
    d_step, _ = jax_trainer.make_steps(jgen, jcritic, tx, tx)
    u_pos, u_dist = _batch()
    d_params, d_state, _, _ = d_step(g_params, d_params, tx.init(d_params), jnp.asarray(u_pos),
                                     jnp.asarray(u_dist), jax.random.PRNGKey(0))
    base = str(tmp_path / "jax")
    jax_checkpoints.save(g_params, trainer.G_NAME, base=base)
    jax_checkpoints.save(d_params, trainer.D_NAME, base=base)
    jax_checkpoints.save({"g": tx.init(g_params), "d": d_state}, trainer.OPT_NAME, base=base)

    generator, critic = trainer.create_models(seed=5)
    trainer._load_module(generator, trainer.G_NAME, base)
    trainer._load_module(critic, trainer.D_NAME, base)
    g_opt = RMSprop(dict(generator.named_parameters()), LR)
    d_opt = RMSprop(dict(critic.named_parameters()), LR)
    trainer._load_optimizers(g_opt, d_opt, base)
    for module, tree in ((generator, g_params), (critic, d_params)):
        got = P.params_to_jax(dict(module.named_parameters()))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), got, tree)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 P.params_to_jax(d_opt.nu), d_state[0].nu)
    flat = checkpoints._flatten(trainer._optimizer_tree(g_opt, d_opt))
    assert "g/0/nu/lin4/kernel" in flat and "d/0/nu/Dense_6/bias" in flat

    port_base = str(tmp_path / "port")
    checkpoints.save(P.params_to_jax(dict(generator.named_parameters())), trainer.G_NAME, base=port_base)
    checkpoints.save(P.params_to_jax(dict(critic.named_parameters())), trainer.D_NAME, base=port_base)
    checkpoints.save(trainer._optimizer_tree(g_opt, d_opt), trainer.OPT_NAME, base=port_base)
    g_back = jax_checkpoints.load(g_params, trainer.G_NAME, base=port_base, strict=True)
    d_back = jax_checkpoints.load(d_params, trainer.D_NAME, base=port_base, strict=True)
    opt_back = jax_checkpoints.load({"g": tx.init(g_params), "d": d_state}, trainer.OPT_NAME,
                                    base=port_base, strict=True)
    for back, tree in ((g_back, g_params), (d_back, d_params), (opt_back["d"][0].nu, d_state[0].nu)):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), back, tree)


def _run(tmp_path, *argv):
    config = parse_cli(["cpu", "synthetic=4", f"model_dir={tmp_path}/models",
                        f"plot_dir={tmp_path}/plots", *argv])
    return trainer.train(config, curriculum=[(128, 2, 2)])


def test_entry_point_micro_run_and_resume(tmp_path):
    """Two epochs straight equal one epoch and a ``continue`` to two: the
    same parameters and moments bit for bit, the same CSV epochs."""
    straight = _run(tmp_path / "straight", "epochs=2")
    first = _run(tmp_path / "resumed", "epochs=1")
    resumed = _run(tmp_path / "resumed", "epochs=2", "continue")
    assert (straight["steps"], first["steps"], resumed["steps"]) == (4, 2, 2)
    for name in ("generator", "discriminator"):
        a = straight[name].state_dict()
        b = resumed[name].state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    for kind in ("straight", "resumed"):
        with open(tmp_path / kind / "plots" / "point_gan_training.csv") as f:
            rows = [line.split() for line in f]
        assert [(r[0], r[1]) for r in rows] == [("128", "1"), ("128", "2")], rows
        assert all(np.isfinite(float(r[3])) for r in rows)
        for name in (trainer.G_NAME, trainer.D_NAME, trainer.OPT_NAME):
            assert checkpoints.exists(name, base=str(tmp_path / kind / "models"))
    with np.load(checkpoints.get_filename(trainer.OPT_NAME, base=str(tmp_path / "straight" / "models"))) as a, \
            np.load(checkpoints.get_filename(trainer.OPT_NAME, base=str(tmp_path / "resumed" / "models"))) as b:
        assert set(a.files) == set(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_entry_point_needs_cuda_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.train(parse_cli(["synthetic=4", f"model_dir={tmp_path}/m", f"plot_dir={tmp_path}/p"]),
                      curriculum=[(128, 2, 1)])


def test_step_noise_is_keyed_by_the_step():
    noise = torch.Generator()
    a = trainer.step_noise(noise, 0, 7, 3, "cpu")
    trainer.step_noise(noise, 0, 8, 3, "cpu")
    b = trainer.step_noise(noise, 0, 7, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (3, trainer.LATENT_SIZE) and a[1].shape == (3, 1, 1)
    assert not torch.equal(a[0], a[2])

"""The port's sharded grid evaluation (``apply_grid_sharded``) on 4 gloo
ranks, a data 2 x points 2 mesh, against the JAX package's
``apply_grid_sharded`` on a 2 x 2 mesh of its virtual CPU devices and
against the port's single process; the volume generators' routing; and a
progressive step pair against the single process."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.ops.coords import voxel_coordinates
from shapegan_tpu.ops.sdf_mlp_pallas import apply_grid_sharded as jax_apply_grid_sharded
from shapegan_tpu.parallel.mesh import get_mesh as jax_get_mesh
from shapegan_tpu_torch import dryrun_multichip
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks

WORLD = 4
FORWARD_ATOL = 1e-5
GRAD_ATOL_PER_SCALE = 2e-3  # tests/test_sharding.py's bound for the sharded grads


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this process's side, as each spawned rank
    has: under pytest-xdist the workers and their ranks share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    params = {k: np.asarray(v) for k, v in
              jax_mlp.init(jax.random.PRNGKey(0), latent_size=16, breadth=32).items()}
    grid = np.asarray(voxel_coordinates(8), dtype=np.float32)
    latents = np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32)
    ranks = mesh_lib.spawn(rank_checks.grid_checks, WORLD, "cpu", args=(params, grid, latents))
    return params, grid, latents, ranks


def _gathered(ranks, key):
    """The ranks' data rows in order (the points ranks of a row agree)."""
    rows = {}
    for r in ranks:
        start = r["rows"][0]
        if start in rows:
            np.testing.assert_array_equal(r[key], rows[start])
        rows[start] = r[key]
    return np.concatenate([rows[s] for s in sorted(rows)])


def test_forward_matches_jax_and_single_process(case):
    params, grid, latents, ranks = case
    got = _gathered(ranks, "forward")
    mesh = jax_get_mesh(data=2, points=2)
    want = np.asarray(jax_apply_grid_sharded(params, jnp.asarray(grid), jnp.asarray(latents), mesh))
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL)
    single = sdf_mlp.apply_grid(sdf_mlp.params_from_jax(params), torch.tensor(grid),
                                torch.tensor(latents)).numpy()
    np.testing.assert_allclose(got, single, atol=FORWARD_ATOL)


def test_trainable_grads_match_jax_and_single_process(case):
    """Gradients of sum(out^2) over the global batch: each rank's backward
    on its point slice, summed over the points group, then over data;
    against the JAX package's unsharded gradients (which its own
    tests/test_sharding.py holds its sharded ones to) and the port's."""
    params, grid, latents, ranks = case
    g_jax = jax.grad(lambda p: jnp.sum(jax_mlp.apply_grid(
        p, jnp.asarray(grid), jnp.asarray(latents)) ** 2))(
        {k: jnp.asarray(v) for k, v in params.items()})
    p = {k: v.requires_grad_(True) for k, v in sdf_mlp.params_from_jax(params).items()}
    out = sdf_mlp.apply_grid(p, torch.tensor(grid), torch.tensor(latents))
    g_single = dict(zip(p, torch.autograd.grad((out * out).sum(), list(p.values()))))
    scale = max(float(np.abs(np.asarray(v)).max()) for v in g_jax.values())
    for r in ranks:
        for k in params:
            np.testing.assert_allclose(r["grads"][k], np.asarray(g_jax[k]),
                                       atol=GRAD_ATOL_PER_SCALE * scale, err_msg=k)
            np.testing.assert_allclose(r["grads"][k], g_single[k].numpy(),
                                       atol=GRAD_ATOL_PER_SCALE * scale, err_msg=k)


def test_generate_volumes_routes_through_apply_grid_sharded(case):
    """Inside the 2 x 2 mesh both volume generators take the sharded route
    and give a rank its rows; outside it none does."""
    ranks = case[3]
    for r in ranks:
        assert r["calls_outside"] == 0
        assert r["calls_inside"] == 2
        assert r["volumes_shape"] == (2, 8, 8, 8)


def test_progressive_step_pair_matches_single_process(case):
    """The dryrun's phase 1 on these ranks: the G and D steps' gradients
    after the data mean against one process (the dryrun's bound)."""
    ranks = case[3]
    single = rank_checks.to_numpy_tree(
        dryrun_multichip.phase_progressive_step(WORLD, torch.device("cpu"), False))
    err = dryrun_multichip.check(1, [r["progressive"] for r in ranks], single, WORLD)
    assert err < dryrun_multichip.BOUNDS[1]
    assert all(r["progressive"]["sharded_calls"] == 2 for r in ranks)


def test_trainable_dispatch_takes_the_chunked_remat_past_2_18(monkeypatch):
    """A rank's evaluation on the CPU takes apply_grid_remat once P * B
    exceeds 2**18 (the JAX package's _trainable_dispatch), with the plain
    evaluation's values and gradients."""
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    params = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in
              jax_mlp.init(jax.random.PRNGKey(2), latent_size=16, breadth=32).items()}
    grid = torch.rand((16384, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1
    latents = torch.randn((17, 16), generator=torch.Generator().manual_seed(4))
    calls = []
    real = sdf_mlp.apply_grid_remat

    def spy(*args, **kw):
        calls.append(kw["chunk_size"])
        return real(*args, **kw)

    monkeypatch.setattr(sdf_mlp, "apply_grid_remat", spy)
    out = K._trainable_dispatch(params, grid, latents)
    assert calls == [16384]
    want = sdf_mlp.apply_grid(params, grid, latents)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), atol=1e-6)
    got = torch.autograd.grad(out.square().sum(), list(params.values()))
    ref = torch.autograd.grad(want.square().sum(), list(params.values()))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)

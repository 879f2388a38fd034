"""The port's SDF MLP (shapegan_tpu_torch.ops.sdf_mlp) and its kernels' plain
versions (ops.sdf_mlp_kernels) held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
weights come from the JAX package's init and reach the port through
``params_from_jax``. The Pallas kernels run in interpret mode, as the JAX
package's own tests run them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.ops import sdf_mlp_pallas
from shapegan_tpu.ops.coords import voxel_coordinates as jax_voxel_coordinates
from shapegan_tpu_torch.ops import _build, sdf_mlp, sdf_mlp_kernels
from shapegan_tpu_torch.ops.coords import unit_sphere_mask, voxel_coordinates

# float32 on both sides (JAX at 'highest' matmul precision, see conftest.py):
# only summation order differs.
F32_ATOL = 1e-5
# bf16 kernels: the TPU kernel and the plain version round to bf16 at the
# same points, so they agree to float32 summation order. Measured on the CPU
# at the shapes below: max 2.2e-8, mean 5.6e-9 (outputs ~0.02-0.08 in
# magnitude). A plain version with a rounding point wrong (no bf16 round
# before the bias add, the layer-5 adds in float32, an fp16 or float32
# trunk) reads max >= 1.4e-4, mean >= 2.3e-5 against the same kernel, so
# these bounds sit between the two.
BF16_MAX_ABS = 1e-5
BF16_MEAN_ABS = 1e-6


def _assert_bf16_close(out, ref):
    diff = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= BF16_MAX_ABS and diff.mean() <= BF16_MEAN_ABS, (diff.max(), diff.mean())


@functools.lru_cache(maxsize=1)
def _params():
    """(numpy, torch) parameter dicts; shared, so tests must not mutate them."""
    np_params = {k: np.asarray(v) for k, v in jax_mlp.init(jax.random.PRNGKey(0)).items()}
    return np_params, sdf_mlp.params_from_jax(np_params)


def _inputs(seed, n_points, n_latents):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    lats = rng.normal(size=(n_latents, 128)).astype(np.float32)
    return pts, lats


def test_coords_match_jax():
    np.testing.assert_array_equal(voxel_coordinates(9).numpy(), jax_voxel_coordinates(9))
    from shapegan_tpu.ops.coords import unit_sphere_mask as jax_mask
    np.testing.assert_array_equal(unit_sphere_mask(9).numpy(), jax_mask(9))


def test_init_matches_jax_layout():
    np_params, _ = _params()
    ported = sdf_mlp.init(torch.Generator().manual_seed(0))
    assert set(ported) == set(np_params)
    for k, v in np_params.items():
        assert tuple(ported[k].shape) == v.shape, k
        bound = float(np.abs(v).max())
        assert float(ported[k].abs().max()) <= bound * 1.05 + 1e-3, k


def test_apply_apply_grid_fold_latent_f32():
    np_params, params = _params()
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    pts, lats = _inputs(1, 500, 3)
    per_point = np.repeat(lats[:1], 500, axis=0)

    out = sdf_mlp.apply(params, torch.tensor(pts), torch.tensor(per_point))
    ref = jax_mlp.apply(jparams, jnp.asarray(pts), jnp.asarray(per_point))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_ATOL)

    out = sdf_mlp.apply_grid(params, torch.tensor(pts), torch.tensor(lats))
    ref = jax_mlp.apply_grid(jparams, jnp.asarray(pts), jnp.asarray(lats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_ATOL)

    folded = sdf_mlp.fold_latent(params, torch.tensor(lats[1]))
    jfolded = jax_mlp.fold_latent(jparams, jnp.asarray(lats[1]))
    for k in ("b1", "b5"):
        np.testing.assert_allclose(folded[k].numpy(), np.asarray(jfolded[k]), atol=F32_ATOL)
    assert folded["w1z"].shape == (0, 256) and folded["w5z"].shape == (0, 256)
    out = sdf_mlp.apply_grid(folded, torch.tensor(pts), torch.zeros(1, 0))
    np.testing.assert_allclose(out.numpy()[0], np.asarray(ref)[1], atol=F32_ATOL)


@pytest.mark.parametrize("res_or_points, batch", [(16, 3), (3000, 2)])
def test_grid_plain_matches_pallas_interpreted(res_or_points, batch):
    """B1's plain version against apply_grid_fused: 16^3 with 3 shapes (many
    512-point tiles), and P=3000 (a padded tail)."""
    np_params, params = _params()
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    if res_or_points == 16:
        pts = voxel_coordinates(16).numpy()
        lats = _inputs(2, 1, batch)[1]
    else:
        pts, lats = _inputs(3, res_or_points, batch)
    out = sdf_mlp_kernels.apply_grid_fused(params, torch.tensor(pts), torch.tensor(lats))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sdf_mlp_pallas.apply_grid_fused(jparams, jnp.asarray(pts), jnp.asarray(lats)))
    assert out.shape == ref.shape and out.dtype == torch.float32
    _assert_bf16_close(out.numpy(), ref)


@pytest.mark.parametrize("folded", [False, True])
def test_points_plain_matches_pallas_interpreted(folded):
    """B3's plain version against apply_points_fused at N=3000 (a padded
    tail), with the latent as an L=128 input and folded into the biases."""
    np_params, params = _params()
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    pts, lats = _inputs(4, 3000, 1)
    lat = lats[0]
    if folded:
        params = sdf_mlp.fold_latent(params, torch.tensor(lat))
        jparams = jax_mlp.fold_latent(jparams, jnp.asarray(lat))
        lat = lat[:0]
    out = sdf_mlp_kernels.apply_points_fused(params, torch.tensor(pts), torch.tensor(lat))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sdf_mlp_pallas.apply_points_fused(
            jparams, jnp.asarray(pts), jnp.asarray(lat), tile=1024))
    assert out.shape == ref.shape == (1, 3000)
    _assert_bf16_close(out.numpy(), ref)


def test_apply_grid_best_dispatch():
    """B == 1 goes to the points kernel's path, B > 1 to the grid kernel's."""
    _, params = _params()
    pts, lats = _inputs(5, 700, 2)
    pts, lats = torch.tensor(pts), torch.tensor(lats)
    one = sdf_mlp_kernels.apply_grid_best(params, pts, lats[:1])
    torch.testing.assert_close(one, sdf_mlp_kernels.apply_points_fused(params, pts, lats[0]))
    two = sdf_mlp_kernels.apply_grid_best(params, pts, lats)
    torch.testing.assert_close(two, sdf_mlp_kernels.apply_grid_fused(params, pts, lats))


def test_cuda_wrappers_raise_on_cpu_tensors():
    """The kernel wrappers launch or raise; they never fall back."""
    _, params = _params()
    pts, lats = _inputs(6, 64, 2)
    grid_ops = sdf_mlp_kernels.grid_operands(params, torch.tensor(pts), torch.tensor(lats))
    points_ops = sdf_mlp_kernels.points_operands(params, torch.tensor(pts), torch.tensor(lats[0]))
    counts = (sdf_mlp_kernels.grid_forward_cuda.launch_count,
              sdf_mlp_kernels.points_forward_cuda.launch_count)
    with pytest.raises(ValueError, match="CUDA kernel"):
        sdf_mlp_kernels.grid_forward_cuda(*grid_ops)
    with pytest.raises(ValueError, match="CUDA kernel"):
        sdf_mlp_kernels.points_forward_cuda(*points_ops)
    with pytest.raises(ValueError, match="CUDA kernel"):  # a non-CPU, non-CUDA device
        sdf_mlp_kernels.grid_forward(*(t.to("meta") for t in grid_ops))
    assert counts == (sdf_mlp_kernels.grid_forward_cuda.launch_count,
                      sdf_mlp_kernels.points_forward_cuda.launch_count)


def test_build_raises_without_nvcc(monkeypatch):
    """Without a CUDA compiler the loader raises instead of returning a
    stand-in."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA build can compile the kernels")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "library_path", lambda: "/nonexistent/lib.so")
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load()
    finally:
        _build.load.cache_clear()

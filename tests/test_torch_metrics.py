"""The port's shape metrics (shapegan_tpu_torch.metrics) held against the
JAX package's (shapegan_tpu.metrics) on the CPU: the Chamfer distance, its
matrix, MMD-CD and COV-CD (with the gate's tie of several identical empty
dummies), the rescale, the clouds sampled from voxel volumes and from a
DeepSDF network, and the CLI's ``test`` and ``dataset`` modes."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run_gan_gate
from shapegan_tpu import metrics as jax_metrics
from shapegan_tpu.data.mesh_io import TriangleMesh as JaxTriangleMesh
from shapegan_tpu.data.synthetic import make_voxel_dataset as jax_make_voxel_dataset
from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu_torch import metrics
from shapegan_tpu_torch.examples import octahedron_params
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The scores against the JAX functions on the same clouds, relative: both
# sum (a - b)^2 over x, y, z in float32 and average the minima; only the
# order of the means' float32 sums differs. Read <= 2.1e-7.
SCORE_REL = 1e-6
# Clouds sampled from the same volumes: the same triangle soup (the marching
# tetrahedra test holds the vertices to 1e-5) and the same draws, so the
# rescaled points agree; read 0.
CLOUD_ATOL = 1e-6
# Meshes of a DeepSDF network: the port evaluates it in bf16 (the kernels'
# plain versions), the JAX package in float32 off a TPU, so the vertices
# move by the bf16 rounding of the SDF (~2^-8 of it) over its gradient; every
# corner keeps its sign, so the triangles are the same. Read 1.8e-3. (The
# areas then differ by ~0.5 %, which moves most area-weighted draws to
# other triangles: the clouds are held through the port's mesh.)
NETWORK_VERTEX_ATOL = 1e-2


def _clouds(count, points, seed, spread=1.0):
    """Clouds around one base shape, each moved a little: Chamfer distances
    of ~3e-3, the scale MMD-CD lives at."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(points, 3)).astype(np.float32) * 0.3
    return (base[None] + spread * 0.01 * rng.normal(size=(count, points, 3))).astype(np.float32)


def test_chamfer_distance_matches_jax_and_float64():
    a, b = _clouds(2, 300, 0)
    b = b[:257]
    got = float(metrics.chamfer_distance(a, b, "cpu"))
    want = float(jax_metrics.chamfer_distance(jnp.asarray(a), jnp.asarray(b)))
    d2 = ((a[:, None, :].astype(np.float64) - b[None, :, :]) ** 2).sum(-1)
    exact = d2.min(1).mean() + d2.min(0).mean()
    print(f"chamfer {got:.9e} vs JAX {want:.9e} vs float64 {exact:.9e}")
    assert abs(got - want) <= SCORE_REL * want
    assert abs(got - exact) <= 1e-5 * exact  # float32 sums of ~1e-3 terms
    assert float(metrics.chamfer_distance(a, a, "cpu")) == 0.0


def test_pairwise_mmd_and_cov_match_jax_with_tied_dummies():
    """Generated clouds with two empty ones replaced by the gate's identical
    far-away dummies (their distances to every reference tie), against
    references: the matrix, MMD-CD and COV-CD of the JAX functions."""
    generated = _clouds(6, 200, 1)
    generated[[1, 4]] = 0.0
    generated = run_gan_gate._punish_empty(generated, 200)
    reference = _clouds(5, 200, 1, spread=1.5)
    got = metrics.pairwise_chamfer(generated, reference, "cpu")
    want = jax_metrics.pairwise_chamfer(generated, reference)
    assert got.shape == (6, 5) and got.dtype == np.float32
    rel = float((np.abs(got - want) / np.abs(want)).max())
    print(f"pairwise: max |d| / |ref| {rel:.3e}")
    assert rel <= SCORE_REL
    assert np.array_equal(got[1], got[4]) and np.array_equal(got.argmin(axis=1), want.argmin(axis=1))
    for ours, theirs in ((metrics.minimum_matching_distance, jax_metrics.minimum_matching_distance),
                         (metrics.coverage, jax_metrics.coverage)):
        a, b = ours(generated, reference, "cpu"), theirs(generated, reference)
        assert abs(a - b) <= SCORE_REL * abs(b), (ours.__name__, a, b)
    # More pairs than a device chunk holds: the chunks stitch in order.
    many = metrics.pairwise_chamfer(_clouds(7, 40, 2), _clouds(6, 33, 3), "cpu")
    assert 7 * 6 > metrics.PAIR_CHUNK
    np.testing.assert_allclose(many, jax_metrics.pairwise_chamfer(_clouds(7, 40, 2), _clouds(6, 33, 3)),
                               rtol=SCORE_REL)


@pytest.mark.parametrize("method", ["sphere", "cube"])
def test_rescale_point_cloud_matches_jax(method):
    points = np.random.default_rng(4).normal(size=(500, 3)).astype(np.float32) * 3 + 1
    got = metrics.rescale_point_cloud(points, method)
    np.testing.assert_array_equal(got, jax_metrics.rescale_point_cloud(points, method))
    assert got.dtype == np.float32
    with pytest.raises(ValueError):
        metrics.rescale_point_cloud(points, "ball")


def test_sample_from_voxels_matches_jax():
    """The JAX package's synthetic volumes (not rescaled, as the gate's
    ground truth) and an all-positive one (an empty mesh: zeros)."""
    voxels = jax_make_voxel_dataset(2, 24, rescale=False, seed=3)
    voxels = np.concatenate([voxels, np.ones((1, 24, 24, 24), np.float32)])
    got = metrics.sample_from_voxels(voxels, point_count=500, seed=5, device="cpu")
    want = jax_metrics.sample_from_voxels(voxels, point_count=500, seed=5)
    assert got.shape == (3, 500, 3) and not got[2].any() and got[:2].any(axis=(1, 2)).all()
    print(f"sample_from_voxels: max |d| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=CLOUD_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got[:2], axis=-1).max(axis=1), 0.5, rtol=1e-6)


def test_sample_point_clouds_matches_jax():
    """A network with a surface (the analytic octahedron; the bundled one has
    none) at 24^3, two codes: each mesh against the JAX network's, and each
    cloud against the JAX package's sampling and rescale of the port's mesh."""
    params = octahedron_params()
    codes = np.random.default_rng(6).normal(size=(2, 128)).astype(np.float32)
    net = SDFNet(sdf_mlp.params_from_jax(params))
    got = metrics.sample_point_clouds(net, torch.tensor(codes), point_count=400,
                                      voxel_resolution=24, seed=7)
    assert got.shape == (2, 400, 3) and got.dtype == np.float32
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    for i, code in enumerate(codes):
        mesh = net.get_mesh(torch.tensor(code), voxel_resolution=24)
        ref = JaxSDFNet().get_mesh(jax_params, code, voxel_resolution=24)
        assert mesh.faces.shape == ref.faces.shape
        err = float(np.abs(mesh.vertices - ref.vertices).max())
        print(f"code {i}: {len(mesh.faces)} triangles, vertices max |d| {err:.3e}")
        assert err <= NETWORK_VERTEX_ATOL
        want = jax_metrics.rescale_point_cloud(
            JaxTriangleMesh(mesh.vertices, mesh.faces).sample(400, seed=7 + i))
        np.testing.assert_array_equal(got[i], want)


def _cli(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")  # no card, on any host
    return subprocess.run([sys.executable, "-m", "shapegan_tpu_torch.metrics", *argv], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)


def test_cli_test_and_dataset_modes(tmp_path):
    """``test`` prints the Chamfer self-check; ``dataset`` writes 32^3
    synthetic clouds to data/eval/dataset.npy; with generated clouds beside
    them it prints MMD-CD and COV-CD; without ``cpu`` it refuses to start
    on a host without CUDA; an unknown mode exits."""
    proc = _cli(tmp_path, "test", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    a = np.random.default_rng(0).normal(size=(512, 3)).astype(np.float32)
    want = float(jax_metrics.chamfer_distance(a, a + 0.1))
    assert lines[0] == "chamfer(a, a) = 0.0" and lines[1].startswith("chamfer(a, a+0.1) = ")
    assert abs(float(lines[1].split("= ")[1]) - want) <= SCORE_REL * want

    proc = _cli(tmp_path, "dataset", "cpu", "synthetic=3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    clouds = np.load(tmp_path / "data" / "eval" / "dataset.npy")
    assert clouds.shape == (3, metrics.POINT_COUNT, 3) and clouds.any(axis=(1, 2)).all()
    np.save(tmp_path / "data" / "eval" / "generated.npy", clouds[::-1].copy())
    proc = _cli(tmp_path, "test", "cpu")
    assert "MMD-CD: 0.0" in proc.stdout and "COV-CD: 1.0" in proc.stdout, proc.stdout

    proc = _cli(tmp_path, "test")
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    proc = _cli(tmp_path, "bogus", "cpu")
    assert proc.returncode != 0 and "unknown mode bogus" in proc.stderr

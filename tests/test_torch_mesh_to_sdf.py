"""The port's mesh → SDF engine held against the JAX package's on the CPU.

* The C++ engine (the same source and flags) on every fixture:
  scan-signed, parity-signed and unsigned queries equal the JAX engine's to
  the bit.
* The engine against its numpy plain versions at 256^2 scans: unsigned
  distances within 1e-5 (float32 BVH against float32 brute force), and
  scan signs equal outside the one-texel band of the plain version's scans
  (the bias 2 * half_extent / res that both compare depths with; within it
  the two rasterizers' texel coverage may differ).
* The sampling functions and ``mesh_to_voxels`` with the same generator
  equal the JAX package's.
* A failed build raises; nothing falls back to numpy unless asked.
"""

import numpy as np
import pytest

from shapegan_tpu.data import fixtures as jax_fixtures
from shapegan_tpu.data import mesh_to_sdf as jax_m
from shapegan_tpu_torch.data import fixtures, mesh_to_sdf
from shapegan_tpu_torch.data.mesh_io import TriangleMesh

FIXTURES = ["box_mesh", "uv_sphere_mesh", "open_box", "double_wall_box", "overlapping_union",
            "degenerate_soup", "chair_like"]
UNSIGNED_ATOL = 1e-5


def points(n=2000, seed=0, scale=1.0):
    return (np.random.default_rng(seed).uniform(-1, 1, (n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("name", FIXTURES)
def test_engine_queries_equal_jax_bitwise(name):
    mesh, jax_mesh = getattr(fixtures, name)(), getattr(jax_fixtures, name)()
    pts = points()
    ours, theirs = mesh_to_sdf.MeshSDF(mesh), jax_m.MeshSDF(jax_mesh)
    assert ours._handle is not None and theirs._handle is not None
    assert ours.scan_resolution == theirs.scan_resolution == 1024
    for signed in (True, False):
        a, b = ours.query(pts, signed=signed), theirs.query(pts, signed=signed)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    a = mesh_to_sdf.MeshSDF(mesh, sign_method="parity").query(pts)
    np.testing.assert_array_equal(a, jax_m.MeshSDF(jax_mesh, sign_method="parity").query(pts))


@pytest.mark.parametrize("name", FIXTURES)
def test_engine_against_plain_versions(name):
    mesh = (fixtures.uv_sphere_mesh(n_lat=8, n_lon=16) if name == "uv_sphere_mesh"
            else getattr(fixtures, name)())
    pts = points(600, seed=1, scale=0.9)
    native = mesh_to_sdf.MeshSDF(mesh, scan_resolution=mesh_to_sdf.NUMPY_SCAN_RESOLUTION)
    plain = mesh_to_sdf.MeshSDF(mesh, use_native=False)
    assert plain._handle is None and plain.scan_resolution == mesh_to_sdf.NUMPY_SCAN_RESOLUTION
    np.testing.assert_allclose(native.query(pts, signed=False), plain.query(pts, signed=False),
                               atol=UNSIGNED_ATOL, rtol=0)
    got, want = native.query(pts), plain.query(pts)
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=UNSIGNED_ATOL, rtol=0)
    lo, hi = mesh.bounding_box
    texel = 2.0 * (float(np.linalg.norm((hi - lo) / 2)) * 1.02 + 1e-6) / plain.scan_resolution
    clear = np.abs(want) > texel
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.sign(got[clear]), np.sign(want[clear]))
    parity = mesh_to_sdf.MeshSDF(mesh, sign_method="parity").query(pts)
    plain_parity = mesh_to_sdf.MeshSDF(mesh, use_native=False, sign_method="parity").query(pts)
    np.testing.assert_allclose(parity, plain_parity, atol=UNSIGNED_ATOL, rtol=0)


def test_scans_are_lazy_and_signs_follow_the_scans():
    mesh = fixtures.double_wall_box(outer=0.5, wall=0.1)
    oracle = mesh_to_sdf.MeshSDF(mesh)
    assert oracle.query(np.array([[2.0, 0, 0]]), signed=False)[0] > 0
    assert not oracle._scans_built
    # the hidden cavity is inside under scans, outside under parity
    hollow = np.array([[0.0, 0.0, 0.0], [0.1, 0.05, -0.1]], np.float32)
    assert (oracle.query(hollow) < 0).all() and oracle._scans_built
    assert (mesh_to_sdf.MeshSDF(mesh, sign_method="parity").query(hollow) > 0).all()
    with pytest.raises(ValueError):
        mesh_to_sdf.MeshSDF(mesh, sign_method="winding")
    with pytest.raises(ValueError):
        mesh_to_sdf.MeshSDF(TriangleMesh(np.zeros((0, 3)), np.zeros((0, 3)))).query(hollow)


@pytest.mark.parametrize("pad", [False, True])
def test_mesh_to_voxels_equals_jax(pad):
    ours = mesh_to_sdf.mesh_to_voxels(fixtures.chair_like(2), 16, pad=pad)
    theirs = jax_m.mesh_to_voxels(jax_fixtures.chair_like(2), 16, pad=pad)
    assert ours.shape == ((18,) * 3 if pad else (16,) * 3)
    np.testing.assert_array_equal(ours, theirs)


def test_sampling_functions_equal_jax_with_a_shared_generator():
    mesh = fixtures.overlapping_union().scaled_to_unit_sphere()
    jax_mesh = jax_fixtures.overlapping_union().scaled_to_unit_sphere()
    rng, jax_rng = np.random.default_rng(7), np.random.default_rng(7)
    np.testing.assert_array_equal(mesh_to_sdf.sample_uniform_sdf(mesh, 3000, rng=rng),
                                  jax_m.sample_uniform_sdf(jax_mesh, 3000, rng=jax_rng))
    ours = mesh_to_sdf.sample_surface_sdf(mesh, 2000, rng=rng, seed=11)
    np.testing.assert_array_equal(ours, jax_m.sample_surface_sdf(jax_mesh, 2000, rng=jax_rng,
                                                                 seed=11))
    assert ours.shape == (2000, 4) and np.abs(ours[:, 3]).mean() < 0.1
    points_, sdf = mesh_to_sdf.sample_sdf_near_surface(mesh, 4001, rng=rng)
    jax_points, jax_sdf = jax_m.sample_sdf_near_surface(jax_mesh, 4001, rng=jax_rng)
    np.testing.assert_array_equal(points_, jax_points)
    np.testing.assert_array_equal(sdf, jax_sdf)
    assert points_.shape == (4001, 3) and (np.abs(sdf) < 0.1).mean() > 0.5


def test_bad_meshes_raise_as_in_jax():
    for make in (lambda f: f.open_box(),
                 lambda f: f.box_mesh((0.001, 0.001, 0.001), center=(0.9, 0, 0))):
        with pytest.raises(mesh_to_sdf.BadMeshException):
            mesh_to_sdf.sample_uniform_sdf(make(fixtures), 2000, rng=np.random.default_rng(0))
        with pytest.raises(jax_m.BadMeshException):
            jax_m.sample_uniform_sdf(make(jax_fixtures), 2000, rng=np.random.default_rng(0))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source revision without a library must build; a missing compiler
    or a compile error raises (no numpy fallback)."""
    source = tmp_path / "mesh_sdf.cpp"
    source.write_text(open(mesh_to_sdf.SOURCE).read() + "\n// a revision with no library yet\n")
    monkeypatch.setattr(mesh_to_sdf, "SOURCE", str(source))
    mesh_to_sdf._engine.cache_clear()
    try:
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(RuntimeError, match="cannot be built"):
            mesh_to_sdf.MeshSDF(fixtures.box_mesh())
        monkeypatch.setenv("CXX", "g++")
        source.write_text("this is not C++\n")
        with pytest.raises(RuntimeError, match="failed to build"):
            mesh_to_sdf.build_engine()
        assert not [p for p in (tmp_path / "build").iterdir() if p.suffix == ".so"]
    finally:
        mesh_to_sdf._engine.cache_clear()

"""The port's mesh I/O, fixtures, taxonomy and example chair held against
the JAX package on the CPU: OBJ and STL files written by either package
load in the other to the same arrays; weld, the two scalings and the
vertex normals equal; the fixture corpus's ``.obj`` files are the same
bytes; the example chair's mesh has the same faces and vertices."""

import os

import numpy as np
import pytest

from shapegan_tpu import examples as jax_examples
from shapegan_tpu.data import fixtures as jax_fixtures
from shapegan_tpu.data import mesh_io as jax_mesh_io
from shapegan_tpu.data import shapenet as jax_shapenet
from shapegan_tpu.data import synthetic as jax_synthetic
from shapegan_tpu_torch import examples
from shapegan_tpu_torch.data import fixtures, mesh_io, shapenet, synthetic

FIXTURES = ["box_mesh", "uv_sphere_mesh", "open_box", "double_wall_box", "overlapping_union",
            "degenerate_soup", "chair_like"]


def assert_same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert a.vertices.dtype == b.vertices.dtype == np.float32
    assert a.faces.dtype == b.faces.dtype == np.int32


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_meshes_match_jax(name):
    assert_same_mesh(getattr(fixtures, name)(), getattr(jax_fixtures, name)())


def test_merge_meshes_matches_jax():
    parts = [fixtures.box_mesh((0.2, 0.3, 0.4), center=(0.1, 0, 0)), fixtures.uv_sphere_mesh(0.3)]
    jax_parts = [jax_mesh_io.TriangleMesh(p.vertices, p.faces) for p in parts]
    assert_same_mesh(fixtures.merge_meshes(*parts), jax_fixtures.merge_meshes(*jax_parts))


def test_fixture_corpus_bytes_match_jax(tmp_path):
    ours = fixtures.make_fixture_corpus(str(tmp_path / "ours"), count=9, seed=3)
    theirs = jax_fixtures.make_fixture_corpus(str(tmp_path / "theirs"), count=9, seed=3)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


@pytest.mark.parametrize("suffix", [".obj", ".stl"])
def test_mesh_files_round_trip_both_ways(tmp_path, suffix):
    mesh = fixtures.chair_like(5)
    jax_mesh = jax_mesh_io.TriangleMesh(mesh.vertices, mesh.faces)
    ours_path, theirs_path = str(tmp_path / f"ours{suffix}"), str(tmp_path / f"theirs{suffix}")
    mesh.save(ours_path)
    jax_mesh.save(theirs_path)
    with open(ours_path, "rb") as fa, open(theirs_path, "rb") as fb:
        assert fa.read() == fb.read()
    for path in (ours_path, theirs_path):
        assert_same_mesh(mesh_io.load_mesh(path), jax_mesh_io.load_mesh(path))
    loaded = mesh_io.load_mesh(ours_path)
    if suffix == ".obj":
        np.testing.assert_allclose(loaded.vertices, mesh.vertices, atol=1e-7)
        np.testing.assert_array_equal(loaded.faces, mesh.faces)
    else:  # STL keeps triangles, not indices: the same surface after a weld
        np.testing.assert_array_equal(np.sort(loaded.triangles.reshape(-1, 9), axis=0),
                                      np.sort(mesh.weld().triangles.reshape(-1, 9), axis=0))


def test_ascii_stl_and_obj_polygons(tmp_path):
    """The readers' other branches: ASCII STL, quads fanned into triangles,
    negative and ``v/vt/vn`` indices."""
    stl = tmp_path / "tri.stl"
    stl.write_text("solid t\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\nvertex 1 0 0\n"
                   "vertex 0 1 0\nendloop\nendfacet\nfacet normal 0 0 1\nouter loop\n"
                   "vertex 1 0 0\nvertex 1 1 0\nvertex 0 1 0\nendloop\nendfacet\nendsolid t\n")
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nf 1/1 2/1 3/1 4/1\nf -4 -3 -1\n")
    for path in (str(stl), str(obj)):
        ours, theirs = mesh_io.load_mesh(path), jax_mesh_io.load_mesh(path)
        assert_same_mesh(ours, theirs)
    assert len(mesh_io.load_mesh(str(stl)).vertices) == 4
    assert mesh_io.load_mesh(str(obj)).faces.tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 3]]
    with pytest.raises(ValueError):
        mesh_io.load_mesh(str(tmp_path / "x.ply"))


@pytest.mark.parametrize("name", ["chair_like", "degenerate_soup", "uv_sphere_mesh"])
def test_geometry_matches_jax(name):
    ours = getattr(fixtures, name)()
    theirs = getattr(jax_fixtures, name)()
    assert_same_mesh(ours.weld(), theirs.weld())
    assert_same_mesh(ours.weld(decimals=2), theirs.weld(decimals=2))
    assert_same_mesh(ours.scaled_to_unit_sphere(), theirs.scaled_to_unit_sphere())
    assert_same_mesh(ours.scaled_to_unit_cube(), theirs.scaled_to_unit_cube())
    np.testing.assert_array_equal(ours.vertex_normals, theirs.vertex_normals)
    assert ours.area == theirs.area
    assert ours.bounding_radius == theirs.bounding_radius
    for a, b in zip(ours.bounding_box, theirs.bounding_box):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.sample(500, seed=4), theirs.sample(500, seed=4))
    assert abs(np.linalg.norm(ours.scaled_to_unit_sphere().vertices, axis=1).max() - 1) < 1e-6


def test_shapenet_metadata_matches_jax(tmp_path):
    ours = shapenet.ShapeNetMetadata(directory=str(tmp_path))  # no taxonomy.json: bundled copy
    theirs = jax_shapenet.ShapeNetMetadata(directory=str(tmp_path))
    assert ours.label_count == theirs.label_count >= 5
    assert ours.labels() == theirs.labels()
    chair = ours.categories["03001627"]
    assert chair.name == "chair" and ours.label_for_directory("03001627") == chair.label
    assert ours.label_for_directory("nope") == -1
    assert ours.get_color(chair.label) == theirs.get_color(chair.label) == chair.color


def test_voxel_dataset_files_match_jax(tmp_path):
    ours = synthetic.write_voxel_dataset_files(str(tmp_path / "ours"), 3, resolution=16, seed=2)
    theirs = jax_synthetic.write_voxel_dataset_files(str(tmp_path / "theirs"), 3, resolution=16,
                                                     seed=2)
    assert ours == theirs == ["synthetic_0000", "synthetic_0001", "synthetic_0002"]
    for name in ours:
        np.testing.assert_array_equal(np.load(tmp_path / "ours" / f"{name}.npy"),
                                      np.load(tmp_path / "theirs" / f"{name}.npy"))


def test_example_chair_mesh_matches_jax(tmp_path, monkeypatch):
    """Both packages mesh the analytic chair by marching tetrahedra and
    weld at 6 decimals; a vertex near a rounding boundary could weld
    apart, so the faces are counted and the sorted vertices compared to
    1e-6 (they read equal)."""
    ours = examples.example_chair_mesh(32, device="cpu")
    theirs = jax_examples.example_chair_mesh(32)
    assert len(ours.faces) == len(theirs.faces) > 100
    assert ours.vertices.shape == theirs.vertices.shape
    np.testing.assert_allclose(np.sort(ours.vertices, axis=0), np.sort(theirs.vertices, axis=0),
                               atol=1e-6)
    monkeypatch.setattr(examples, "EXAMPLE_MESH_DIR", str(tmp_path / "meshes"))
    path = examples.example_chair_path(32, device="cpu")
    assert path == str(tmp_path / "meshes" / "chair.obj")
    assert_same_mesh(mesh_io.load_mesh(path), jax_mesh_io.load_mesh(path))
    assert len(mesh_io.load_mesh(path).faces) == len(ours.faces)

"""The port's data preparation held against the JAX package's on the CPU,
on one 5-mesh fixture corpus at small counts: the port's prep at one
worker and at two spawned workers gives the same files; its voxels equal
the JAX prep's to the bit, with the same ``.badmesh`` set; its point
samples, re-queried by the JAX engine, give its SDF column exactly (the
seeds differ on purpose: the port keys them by the CRC-32 of the mesh id);
combine and the splits equal the JAX functions'. Also the entry points
``prepare_data`` and ``prepare_shapenet_dataset``."""

import os
import shutil
import zlib

import numpy as np
import pytest

from shapegan_tpu.data import fixtures as jax_fixtures
from shapegan_tpu.data import mesh_io as jax_mesh_io
from shapegan_tpu.data import mesh_to_sdf as jax_m
from shapegan_tpu.data import prepare as jax_prepare
from shapegan_tpu_torch import prepare_data, prepare_shapenet_dataset
from shapegan_tpu_torch.data import fixtures, prepare

COUNTS = dict(voxel_resolutions=[8, 16], uniform_count=1500, surface_count=1200, cloud_count=2000)


def config(out, **kw):
    return prepare.PrepareConfig(output_dir=str(out), **{**COUNTS, **kw})


def files(directory):
    return sorted(os.path.relpath(os.path.join(d, f), directory)
                  for d, _, names in os.walk(directory) for f in names)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The 5-mesh corpus, prepared by the port (one worker, two workers)
    and by the JAX package (one worker)."""
    root = tmp_path_factory.mktemp("corpus")
    paths = fixtures.make_fixture_corpus(str(root / "meshes"), count=5, seed=0)
    one = prepare.process_mesh_files(paths, config(root / "one"), workers=1)
    two = prepare.process_mesh_files(paths, config(root / "two", workers=2))
    jax_results = jax_prepare.process_mesh_files(
        paths, jax_prepare.PrepareConfig(output_dir=str(root / "jax"), **COUNTS), workers=1)
    return root, paths, (one, two, jax_results)


def test_prepared_files_match_across_workers_and_jax_voxels(corpus):
    root, paths, (one, two, jax_results) = corpus
    assert one == two == jax_results == ["bad", "ok", "ok", "ok", "ok"]  # the open box
    assert files(root / "one") == files(root / "two")
    for name in files(root / "one"):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(root / "one" / name), np.load(root / "two" / name))
    ours_vox = [f for f in files(root / "one") if f.startswith("voxels_")]
    assert ours_vox == [f for f in files(root / "jax") if f.startswith("voxels_")]
    assert len(ours_vox) == 2 * 5  # the open box's voxels come before its quarantine
    for name in ours_vox:
        np.testing.assert_array_equal(np.load(root / "one" / name), np.load(root / "jax" / name))
    badmesh = [f for f in files(root / "one") if f.endswith(".badmesh")]
    assert badmesh == [f for f in files(root / "jax") if f.endswith(".badmesh")] == [
        "fixture_000.badmesh"]


def test_point_samples_requeried_by_the_jax_engine(corpus):
    root, paths, _ = corpus
    for path in paths[1:]:
        stem = os.path.splitext(os.path.basename(path))[0]
        oracle = jax_m.MeshSDF(jax_mesh_io.load_mesh(path).scaled_to_unit_sphere())
        for kind, count in (("uniform", 1500), ("surface", 1200), ("cloud", 2000)):
            data = np.load(root / "one" / kind / f"{stem}.npy")
            assert data.shape == (count, 4) and data.dtype == np.float32
            np.testing.assert_array_equal(oracle.query(data[:, :3]), data[:, 3])
        uniform = np.load(root / "one" / "uniform" / f"{stem}.npy")
        assert (uniform[:, 3] < 0).mean() >= 0.01
        assert np.linalg.norm(uniform[:, :3], axis=1).max() <= 1.0


def test_point_seeds_are_stable_digests(corpus, tmp_path):
    """The seed is crc32(id): one mesh prepared alone, in another directory,
    draws the same samples; two ids draw different ones."""
    root, paths, _ = corpus
    assert prepare.mesh_seed("fixture_001") == zlib.crc32(b"fixture_001") == 226515804
    alone = config(tmp_path, make_voxels=False)
    assert prepare.process_mesh_file(paths[1], alone) == "ok"
    for kind in ("uniform", "surface", "cloud"):
        np.testing.assert_array_equal(np.load(tmp_path / kind / "fixture_001.npy"),
                                      np.load(root / "one" / kind / "fixture_001.npy"))
    a = np.load(root / "one" / "uniform" / "fixture_001.npy")
    b = np.load(root / "one" / "uniform" / "fixture_002.npy")
    assert not np.array_equal(a[:, :3], b[:, :3])


def test_prep_is_idempotent(corpus):
    root, paths, _ = corpus
    before = {f: os.path.getmtime(root / "one" / f) for f in files(root / "one")}
    assert prepare.process_mesh_files(paths, config(root / "one"), workers=1) == ["skipped"] * 5
    assert {f: os.path.getmtime(root / "one" / f) for f in files(root / "one")} == before


def test_combine_and_splits_equal_jax(corpus, tmp_path):
    root, _, _ = corpus
    for name, module in (("ours", prepare), ("theirs", jax_prepare)):
        out = tmp_path / name / "fixtures"
        shutil.copytree(root / "one", out)
        cfg = module.PrepareConfig(output_dir=str(out), **COUNTS)
        module.combine_sdf_clouds(cfg)
        module.write_split_file(cfg, train_fraction=0.6, seed=3)
    for name in ("sdf_points.npy", "sdf_values.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "ours" / name),
                                      np.load(tmp_path / "theirs" / name))
    assert np.load(tmp_path / "ours" / "sdf_points.npy").shape == (4 * 2000, 3)
    for name in ("train.txt", "test.txt"):
        ours = (tmp_path / "ours" / "fixtures" / name).read_text()
        assert ours == (tmp_path / "theirs" / "fixtures" / name).read_text()
    assert len(ours.split()) == 2 and "fixture_000" in (
        (tmp_path / "ours" / "fixtures" / "train.txt").read_text() + ours)


def test_rotation_matches_jax(tmp_path):
    mesh_dir = tmp_path / "meshes"
    mesh_dir.mkdir()
    path = str(mesh_dir / "chair.stl")
    fixtures.chair_like(4).save(path)
    kw = dict(voxel_resolutions=[16], make_points=False, make_cloud=False, rotation=30.0)
    ours = prepare.PrepareConfig(str(tmp_path / "a"), **kw)
    theirs = jax_prepare.PrepareConfig(str(tmp_path / "b"), **kw)
    assert prepare.process_mesh_file(path, ours) == jax_prepare.process_mesh_file(path, theirs) == "ok"
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "voxels_16" / "chair.npy"),
                                  np.load(tmp_path / "b" / "voxels_16" / "chair.npy"))
    unrotated = prepare.PrepareConfig(str(tmp_path / "c"), **{**kw, "rotation": None})
    prepare.process_mesh_file(path, unrotated)
    assert not np.array_equal(np.load(tmp_path / "a" / "voxels_16" / "chair.npy"),
                              np.load(tmp_path / "c" / "voxels_16" / "chair.npy"))


def test_prepare_data_entry_point(tmp_path, capsys):
    meshes = tmp_path / "in" / "sub"
    meshes.mkdir(parents=True)
    fixtures.uv_sphere_mesh(0.5, n_lat=8, n_lon=16).save(str(meshes / "ball.obj"))
    fixtures.box_mesh((0.4, 0.3, 0.2)).save(str(meshes / "brick.stl"))
    out = tmp_path / "data" / "custom"
    prepare_data.main(["--input", str(tmp_path / "in"), "--output", str(out), "--resolutions",
                       "8", "--cloud-count", "1000", "--workers", "1", "--no-points",
                       "--combine", "--split"])
    assert "prepared 2, skipped 0, bad 0" in capsys.readouterr().out
    assert sorted(os.listdir(out / "voxels_8")) == ["ball.npy", "brick.npy"]
    assert not (out / "uniform").exists()
    assert np.load(tmp_path / "data" / "sdf_points.npy").shape == (2000, 3)
    assert (out / "train.txt").exists() and (out / "test.txt").exists()
    with pytest.raises(SystemExit):
        prepare_data.main(["--input", str(tmp_path / "empty")])


def test_prepare_shapenet_entry_point(tmp_path):
    """The ShapeNet layout with the bundled taxonomy: ids from the
    directory names, the category's own output directory."""
    dataset = tmp_path / "ShapeNetCore.v2"
    for shape_id, size in (("a1", 0.3), ("b2", 0.4)):
        models = dataset / "03001627" / shape_id / "models"
        models.mkdir(parents=True)
        fixtures.box_mesh((size, 0.3, 0.3)).save(str(models / "model_normalized.obj"))
    prepare_shapenet_dataset.main(["--dataset", str(dataset), "--categories", "chairs",
                                   "--output", str(tmp_path / "data"), "--workers", "1",
                                   "--limit", "1", "--split"])
    out = tmp_path / "data" / "chairs"
    assert sorted(os.listdir(out / "voxels_64")) == ["a1.npy"]
    assert np.load(out / "uniform" / "a1.npy").shape == (64**3, 4)
    assert np.load(out / "cloud" / "a1.npy").shape == (200000, 4)
    assert (out / "train.txt").read_text().split() + (out / "test.txt").read_text().split() == ["a1"]
    with pytest.raises(SystemExit):
        prepare_shapenet_dataset.main(["--dataset", str(dataset), "--categories", "lamps"])


def test_port_autoencoder_trains_on_jax_prepared_voxels(tmp_path, monkeypatch):
    """Voxels the JAX package prepared train the port's classic AE (the
    same layout, ``data/<category>/voxels_32/<id>.npy`` and the splits)."""
    from shapegan_tpu_torch.core.config import parse_cli
    from shapegan_tpu_torch.train import autoencoder

    paths = jax_fixtures.make_fixture_corpus(str(tmp_path / "meshes"), count=3, seed=1)
    cfg = jax_prepare.PrepareConfig(output_dir=str(tmp_path / "data" / "fix"),
                                    voxel_resolutions=[32], make_points=False, make_cloud=False)
    assert jax_prepare.process_mesh_files(paths, cfg, workers=1) == ["ok"] * 3
    jax_prepare.write_split_file(cfg, train_fraction=0.7)
    monkeypatch.chdir(tmp_path)
    result = autoencoder.train(parse_cli(["cpu", "classic", "epochs=1", "batch_size=2",
                                          "category=fix"]))
    assert result["steps"] == 1  # two shapes in train.txt, batch 2
    assert np.isfinite(np.loadtxt("plots/autoencoder_training.csv")).all()

"""The port's GAN quality gate (shapegan_tpu_torch.gan_gate) on the CPU: its
scoring and log checks against the JAX gate's (run_gan_gate.py), the sheet's
tiles against the JAX viewer's, the exit codes, and a whole gate at a micro
budget (the voxel GAN, the progressive chain 0 -> 3, scores, sheet and
record)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import run_gan_gate as jax_gate
from shapegan_tpu.data.mesh_io import TriangleMesh as JaxTriangleMesh
from shapegan_tpu.data.synthetic import make_voxel_dataset as jax_make_voxel_dataset
from shapegan_tpu.render.viewer import MeshRenderer as JaxMeshRenderer
from shapegan_tpu.util import crop_image as jax_crop_image
from shapegan_tpu_torch import gan_gate
from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.render.png import read_png
from shapegan_tpu_torch.render.viewer import MeshRenderer
from shapegan_tpu_torch.util import crop_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A sheet tile against the JAX viewer's software route on the same scene:
# the same rasterizer source and the same triangles, so the full frames are
# equal; OpenCV's INTER_AREA and the port's resize_area round a few pixels
# apart (OpenCV's fixed-point coefficients when enlarging): at most 1 grey
# level.
TILE_MAX_LEVELS = 1
# The record's envelope (run_gan_gate.py's keys, and the port's device).
RECORD_KEYS = {"gate", "voxel_gan", "progressive", "thresholds", "config", "sample_sheet", "pass",
               "failures", "device"}
CONFIG_KEYS = {"shapes", "samples", "gan_epochs", "prog_epochs", "point_count", "gt_count", "seed",
               "prog_g_every", "prog_lr", "prog_d_lr"}


def test_punish_empty_replaces_allzero_clouds():
    clouds = np.zeros((3, 16, 3), np.float32)
    clouds[1] = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    out = gan_gate._punish_empty(clouds, 16)
    assert np.all(out[0] == 10.0) and np.all(out[2] == 10.0)
    np.testing.assert_array_equal(out[1], clouds[1])
    assert np.all(clouds[0] == 0.0)
    np.testing.assert_array_equal(out, jax_gate._punish_empty(clouds, 16))


def test_assert_finite_csv(tmp_path):
    good = tmp_path / "good.csv"
    good.write_text("0 1.5 0.1 0.2 9.8\n1 1.4 0.1 0.2 9.7\n")
    gan_gate._assert_finite_csv(str(good), 0)
    bad = tmp_path / "bad.csv"
    bad.write_text("0 1.5 nan 0.2 9.8\n")
    with pytest.raises(AssertionError, match="non-finite"):
        gan_gate._assert_finite_csv(str(bad), 2)
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    with pytest.raises(AssertionError, match="empty"):
        gan_gate._assert_finite_csv(str(empty), 1)


def test_default_gates_are_the_jax_gates():
    assert gan_gate.DEFAULT_GATES == jax_gate.DEFAULT_GATES


@pytest.mark.parametrize("case", ["small", "large", "blank", "greyscale"])
def test_crop_image_matches_jax(case):
    """Content narrower than 200 pixels is left uncropped, wider content is
    cropped to a square clamped to the image, a blank image stays whole."""
    image = np.full((256, 240, 3), 255, np.uint8)
    if case == "small":
        image[30:90, 100:130] = 7
    elif case in ("large", "greyscale"):
        image[5:250, 20:230, 1] = 0
    if case == "greyscale":
        image = image.mean(axis=2).astype(np.uint8)
    got, want = crop_image(image.copy()), jax_crop_image(image.copy())
    assert got.shape == want.shape and (case != "large" or got.shape[:2] != image.shape[:2])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", ["voxels", "mesh", "greyscale"])
def test_sheet_tiles_match_jax_viewer(scene):
    """A tile as the sheet makes it (a 256^2 frame, cropped, area-resized to
    128^2) against the JAX viewer's software route (its GL route is forced
    off) on the same volume or mesh."""
    volume = jax_make_voxel_dataset(1, 32, rescale=False, seed=2)[0]
    ours, theirs = MeshRenderer(size=256, start_thread=False), JaxMeshRenderer(size=256, start_thread=False)
    theirs._gl_failed = True
    for viewer in (ours, theirs):
        viewer.model_color = (0.25, 0.45, 0.8)
        viewer.rotation = [147.0, 20.0]
    if scene == "mesh":
        vertices = np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32) * 0.6
        faces = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32)
        ours.set_mesh(TriangleMesh(vertices, faces), center_and_scale=True)
        theirs.set_mesh(JaxTriangleMesh(vertices, faces), center_and_scale=True)
    else:
        ours.set_voxels(volume)
        theirs.set_voxels(volume)
    assert ours.model_size == theirs.model_size and ours.ground_level == pytest.approx(theirs.ground_level)
    kw = {"crop": True, "output_size": 128, "greyscale": scene == "greyscale"}
    got, want = ours.get_image(**kw), theirs.get_image(**kw)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (got != 255).any()
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"{scene}: tile {got.shape}, {int((diff > 0).sum())} pixels differ, max {int(diff.max())}")
    assert diff.max() <= TILE_MAX_LEVELS
    full_ours, full_theirs = ours.get_image(), theirs.get_image()
    np.testing.assert_array_equal(full_ours, full_theirs)
    # Binary cubes of the same volume: the same mesh in [-1, 1]^3.
    ours.set_voxels(volume, use_marching_cubes=False)
    theirs.set_voxels(volume, use_marching_cubes=False)
    np.testing.assert_array_equal(ours._vertices, theirs._vertices)
    assert ours.model_size == theirs.model_size == 1.4


def _gate(*argv, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")  # no card, on any host
    return subprocess.run([sys.executable, "-m", "shapegan_tpu_torch.gan_gate", *argv], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=120)


def test_exit_codes_bars_failed_is_not_a_crash(tmp_path, monkeypatch):
    """main returns 0 when every bar holds and BARS_FAILED (3) when one
    fails; a crash (a bad option, no CUDA without ``cpu``) exits 1."""
    records = iter([{"failures": []}, {"failures": ["voxel_gan.mmd_cd"]}])
    seen = []

    def fake_run(workdir, **kwargs):
        seen.append((workdir, kwargs))
        return next(records)

    monkeypatch.setattr(gan_gate, "run", fake_run)
    assert gan_gate.main([str(tmp_path), "cpu", "shapes=8", "nosheet", "continue"]) == 0
    assert gan_gate.main(["cpu", "prog_d_lr=0.5", "voxel_mmd_max=0.5"]) == gan_gate.BARS_FAILED == 3
    (workdir, first), (default_dir, second) = seen
    assert workdir == str(tmp_path) and default_dir == "gan_gate_run"
    assert (first["shapes"], first["sheet"], first["resume"], first["device"].type) == (8, False, True, "cpu")
    assert (second["prog_d_lr"], second["gates"], second["gan_epochs"]) == (0.5, {"voxel_mmd_max": 0.5}, 2000)

    crash = _gate(str(tmp_path / "a"), "cpu", "shapes=many")
    assert crash.returncode == 1 and "ValueError" in crash.stderr
    no_cuda = _gate(str(tmp_path / "b"))
    assert no_cuda.returncode == 1 and "CUDA is not available" in no_cuda.stderr


def test_gate_micro_run_on_cpu(tmp_path, capsys):
    """The whole gate at a micro budget through its entry point: one shape,
    one epoch a stage, the chain 0 -> 3 at batch 1. It trains nothing of
    use, so the bars fail (exit code 3) and the progressive samples are
    empty and punished; the record, its GATE line, the logs, the warm-start
    files and the sheet are checked."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        code = gan_gate.main([str(tmp_path), "cpu", "shapes=1", "samples=2", "gan_epochs=1",
                              "prog_epochs=1", "gt_count=1", "point_count=64"])
    finally:
        torch.set_num_threads(threads)
    assert code == gan_gate.BARS_FAILED
    with open(tmp_path / "gate_gan.json") as f:
        record = json.load(f)
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("GATE ")]
    assert len(line) == 1 and json.loads(line[0][5:]) == record
    assert set(record) == RECORD_KEYS and set(record["config"]) == CONFIG_KEYS
    assert record["gate"] == "gan" and record["device"] == "cpu" and record["pass"] is False
    assert record["thresholds"] == gan_gate.DEFAULT_GATES and record["failures"]
    for family in ("voxel_gan", "progressive"):
        scores = record[family]
        assert set(scores) == {"mmd_cd", "cov_cd", "empty_samples"}
        assert np.isfinite(scores["mmd_cd"]) and 0 <= scores["cov_cd"] <= 1
    assert record["progressive"]["mmd_cd"] > 100  # empty samples, punished
    for iteration in range(4):
        rows = np.loadtxt(tmp_path / "plots" / f"hybrid_gan_training_{iteration}.csv", ndmin=2)
        assert rows.shape == (1, 5) and np.isfinite(rows).all()
        assert os.path.exists(tmp_path / "models" / f"hybrid_progressive_gan_generator_{iteration}.npz")
    sheet = read_png(record["sample_sheet"])
    assert sheet.shape == (3 * 132 + 4, 2 * 132 + 4, 3)
    assert (sheet[4:132, 4:132] != 255).any()  # the dataset row has a shape

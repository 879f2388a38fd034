"""The port's fixture-corpus pipeline end to end on the CPU at a micro
budget (the JAX package's tests/test_fixture_corpus.py budget: 5 meshes,
voxels 16 and 32, clouds 4,096, a few epochs; the gate's meshes at 24^3,
one intra-op thread): the artifacts, the ``GATE``
record and ``gate_autodecoder.json`` with the JAX script's keys, the exit
codes (0 when the bars hold, 3 when a bar cannot hold, 1 on a crash or
without CUDA), and the checkpoints and prepared data across the packages:
the port's files load in the JAX package, and the JAX autodecoder trains
on the port's combined cloud and its files load in the port."""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.core.config import TrainConfig as JaxTrainConfig
from shapegan_tpu.train import sdf_autodecoder as jax_ad
from shapegan_tpu_torch import checkpoints, run_fixture_corpus
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from test_torch_autoencoder import _jax_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = ["cpu", "count=5", "epochs=1", "ad_epochs=3", "overfit_epochs=4"]
LOOSE = ["recon_max=inf", "mmd_max=inf", "cov_min=0", "overfit_max=inf"]


@pytest.fixture(scope="module")
def corpus_run(tmp_path_factory):
    """``main`` at the micro budget with loose bars, then again in the same
    directory (stages 1-3 skip their work; one epoch of each autodecoder
    run) with a coverage bar no run can meet; returns the directory, both
    exit codes and both records."""
    workdir = str(tmp_path_factory.mktemp("corpus") / "run")
    micro_run = functools.partial(run_fixture_corpus.run, uniform_count=2048, cloud_count=4096,
                                  voxel_resolutions=(16, 32), mesh_resolution=24)
    mp = pytest.MonkeyPatch()
    mp.setattr(run_fixture_corpus, "run", micro_run)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        codes, records = [], []
        strict = [b if not b.startswith("cov_min") else "cov_min=2" for b in LOOSE]
        for argv in (MICRO + LOOSE, MICRO + ["ad_epochs=1", "overfit_epochs=1"] + strict):
            codes.append(run_fixture_corpus.main([workdir, *argv]))
            with open(os.path.join(workdir, "gate_autodecoder.json")) as f:
                records.append(json.load(f))
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return workdir, codes, records


def test_exit_codes_and_gate_records(corpus_run, capsys):
    workdir, codes, records = corpus_run
    assert codes == [0, run_fixture_corpus.BARS_FAILED] and run_fixture_corpus.BARS_FAILED == 3
    loose, strict = records
    jax_keys = {"gate", "quality", "thresholds", "config", "pass", "failures"}
    assert jax_keys <= set(loose) and loose["gate"] == "autodecoder" and loose["device"] == "cpu"
    assert set(loose["quality"]) == {"recon_chamfer", "mmd_cd", "cov_cd", "overfit_chamfer",
                                     "empty_meshes"}
    assert loose["pass"] and loose["failures"] == []
    assert not strict["pass"] and strict["failures"] == ["cov_cd"]
    inf = float("inf")
    assert strict["thresholds"] == {"recon_max": inf, "mmd_max": inf, "cov_min": 2.0,
                                    "overfit_max": inf}
    assert loose["config"] == {"count": 5, "epochs": 1, "ad_epochs": 3, "overfit_epochs": 4}
    for record in records:
        q = record["quality"]
        assert all(np.isfinite(q[k]) for k in ("recon_chamfer", "mmd_cd", "overfit_chamfer"))
        assert q["mmd_cd"] >= 0 and 0 < q["cov_cd"] <= 1
        assert set(record["timings"]) == {"prepare", "combine", "train_ae", "train_autodecoder",
                                          "plot", "quality_gate"}


def test_artifacts_and_checkpoints(corpus_run):
    workdir, _, _ = corpus_run
    data_dir = os.path.join(workdir, "data", "fixtures")
    assert sorted(os.listdir(os.path.join(workdir, "meshes"))) == [
        f"fixture_{i:03d}.obj" for i in range(5)]
    for res in (16, 32):
        assert len(os.listdir(os.path.join(data_dir, f"voxels_{res}"))) == 5
    assert sorted(os.listdir(os.path.join(data_dir, "cloud"))) == [
        f"fixture_{i:03d}.npy" for i in range(1, 5)]
    assert os.path.exists(os.path.join(data_dir, "fixture_000.badmesh"))  # the open box
    points = np.load(os.path.join(workdir, "data", "sdf_points.npy"))
    assert points.shape == (4 * 4096, 3)
    recon = np.load(os.path.join(workdir, "plots", "fixture_reconstructions.npy"))
    assert recon.shape == (4, 32, 32, 32) and np.isfinite(recon).all()
    models = os.path.join(workdir, "models")
    assert os.path.exists(os.path.join(models, "autoencoder-128.npz"))

    # The port's checkpoints in the JAX package, strictly.
    template = jax_ad.SDFNet().init(jax.random.PRNGKey(0))
    params = jax_checkpoints.load(template, "sdf_net", base=models, strict=True)
    codes = jax_checkpoints.load_array(LATENT_CODES_FILENAME, base=models)
    assert codes.shape == (4, 128) and np.isfinite(codes).all()
    saved = checkpoints.load("sdf_net", base=models)
    for key, value in params.items():
        np.testing.assert_array_equal(np.asarray(value), saved[key].numpy())
    state = _jax_state(False)
    ae_template = jax.tree.map(np.zeros_like, {"params": state.params,
                                               "batch_stats": state.batch_stats,
                                               "opt_state": state.opt_state, "epoch": 0})
    back = jax_checkpoints.load(ae_template, "autoencoder-128", base=models, strict=True)
    assert int(back["epoch"]) == 0


def test_jax_autodecoder_trains_on_the_port_cloud(corpus_run, tmp_path, monkeypatch):
    """The JAX trainer on the port's combined cloud; its files decode in the
    port."""
    workdir, _, _ = corpus_run
    monkeypatch.chdir(tmp_path)
    jax_ad.train(JaxTrainConfig(nogui=True, epochs=1, batch_size=4096,
                                data_dir=os.path.join(workdir, "data"),
                                extras={"pointcloud_size": "4096"}))
    net = SDFNet(checkpoints.load("sdf_net", base="models"))
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base="models")
    assert codes.shape == (4, 128)
    volume = net.get_voxels(codes[0], 8)
    assert volume.shape == (8, 8, 8) and bool(np.isfinite(volume.numpy()).all())


def test_crash_and_missing_cuda_exit_1(tmp_path):
    """Without CUDA and without ``cpu`` the entry point fails; a work
    directory that is a file crashes the first stage. Both exit 1."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    (tmp_path / "a_file").write_text("")
    cmd = [sys.executable, "-m", "shapegan_tpu_torch.run_fixture_corpus"]
    runs = [subprocess.run(cmd + extra, capture_output=True, text=True, timeout=120, env=env,
                           cwd=str(tmp_path)) for extra in (["w"], ["a_file", "cpu"])]
    assert [r.returncode for r in runs] == [1, 1]
    assert "CUDA is not available" in runs[0].stderr
    assert "FileExistsError" in runs[1].stderr and "GATE" not in runs[1].stdout

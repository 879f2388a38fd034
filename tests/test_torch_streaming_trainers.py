"""Each of the six voxel-batch trainers (autoencoder, gan, wgan,
hybrid_gan, hybrid_wgan, hybrid_progressive_gan) one epoch at a micro size
with ``resident=0`` (streamed from the host) and ``resident=1`` (on the
device): the same logged losses, tolerance 0 (the same batches bit for bit,
the same seeds); and the classic AE on voxel files streamed through the
loader's process backend."""

import importlib
import os

import numpy as np
import pytest
import torch

from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.data import synthetic
from shapegan_tpu_torch.train import common


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mode(batches):
    return {common.ResidentBatches: "resident", common.StreamingBatches: "streaming"}[type(batches)]


TRAINERS = [
    ("autoencoder", ["classic", "synthetic=4", "batch_size=2"], "autoencoder_training.csv"),
    ("gan", ["synthetic=4", "batch_size=2"], "gan_training.csv"),
    ("wgan", ["synthetic=4", "batch_size=2"], "wgan_training.csv"),
    ("hybrid_gan", ["synthetic=1", "batch_size=1"], "hybrid_gan_training.csv"),
    ("hybrid_wgan", ["synthetic=1", "batch_size=1"], "hybrid_wgan_training.csv"),
    ("hybrid_progressive_gan", ["iteration=0", "synthetic=4", "batch_size=2"],
     "hybrid_gan_training_0.csv"),
]


def logged_losses(path):
    """The CSV's columns without the epoch time (column 1)."""
    rows = np.loadtxt(path, ndmin=2)
    return np.delete(rows, 1, axis=1)


@pytest.mark.parametrize("name, argv, csv", TRAINERS, ids=[t[0] for t in TRAINERS])
def test_trainers_stream_and_reside_alike(name, argv, csv, tmp_path, monkeypatch, one_thread):
    module = importlib.import_module(f"shapegan_tpu_torch.train.{name}")
    made = []
    make = module.make_voxel_batches

    def spy(*args, **kwargs):
        batches = make(*args, **kwargs)
        made.append(mode(batches))
        return batches

    monkeypatch.setattr(module, "make_voxel_batches", spy)
    losses = {}
    for resident in ("0", "1"):
        os.makedirs(tmp_path / resident)
        monkeypatch.chdir(tmp_path / resident)
        module.train(parse_cli(["cpu", "epochs=1", f"resident={resident}", *argv]))
        losses[resident] = logged_losses(os.path.join("plots", csv))
    assert made == ["streaming", "resident"]
    assert losses["0"].shape == losses["1"].shape and np.isfinite(losses["0"]).all()
    np.testing.assert_array_equal(losses["0"], losses["1"])


def test_autoencoder_streams_files_through_processes(tmp_path, monkeypatch, one_thread):
    """The classic AE on voxel files: ``resident=0`` streams through the
    process backend (``auto``) and logs what ``resident=1`` logs."""
    monkeypatch.chdir(tmp_path)
    synthetic.write_voxel_dataset_files(str(tmp_path / "data" / "chairs" / "voxels_32"), 4)
    from shapegan_tpu_torch.train import autoencoder

    backends = []
    make = autoencoder.make_voxel_batches

    def spy(*args, **kwargs):
        batches = make(*args, **kwargs)
        backends.append(getattr(getattr(batches, "loader", None), "backend", "resident"))
        return batches

    monkeypatch.setattr(autoencoder, "make_voxel_batches", spy)
    losses = {}
    for resident in ("0", "1"):
        autoencoder.train(parse_cli(["cpu", "classic", "batch_size=2", "epochs=1",
                                     f"resident={resident}", f"plot_dir=plots{resident}"]))
        losses[resident] = logged_losses(f"plots{resident}/autoencoder_training.csv")
    want = "process" if (os.cpu_count() or 1) >= 4 else "thread"
    assert backends == [want, "resident"]
    np.testing.assert_array_equal(losses["0"], losses["1"])

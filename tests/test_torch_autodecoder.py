"""The port's DeepSDF autodecoder trainer held against the JAX package's on
the CPU: the synthetic point clouds and the sign-balanced batches bit for
bit, the Adam rule against optax, and a micro training loop (files,
snapshots, CSV, resume and its refusals, the ``scale_lr`` line, checkpoints
read by the other package in both directions).

The loss and its gradients through the rowwise kernels' plain versions are
held against the JAX package in tests/test_torch_rowwise.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapegan_tpu import checkpoints as jax_checkpoints
from shapegan_tpu.core.config import TrainConfig as JaxTrainConfig
from shapegan_tpu.data.synthetic import make_sdf_pointcloud as jax_make_sdf_pointcloud
from shapegan_tpu.models import LATENT_CODES_FILENAME
from shapegan_tpu.train import sdf_autodecoder as jax_trainer
from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.data.synthetic import make_sdf_pointcloud
from shapegan_tpu_torch.optim import Adam
from shapegan_tpu_torch.train import sdf_autodecoder as trainer

MICRO = ["cpu", "synthetic=3", "pointcloud_size=1024", "batch_size=512"]
# The gui epoch's loss against the JAX gui run's from the same files: read
# 1.6e-4 (the rowwise plain versions' bf16 rounding; the CSV's 6 decimals).
GUI_LOSS_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores, and PyTorch's default of a thread per core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("count, per_shape, seed", [(3, 1024, 0), (2, 777, 5)])
def test_make_sdf_pointcloud_bit_identical(count, per_shape, seed):
    got = make_sdf_pointcloud(count, per_shape, seed=seed)
    want = jax_make_sdf_pointcloud(count, per_shape, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_create_batches_bit_identical():
    """The same index batches, padded tail included, from the same
    generator state; one-sign data is refused by both."""
    _, sdf = make_sdf_pointcloud(3, 1024, seed=1)
    signs = np.clip(sdf, -0.1, 0.1) > 0
    for epoch in range(2):
        got = list(trainer.create_batches(signs, 70, np.random.default_rng((0, epoch))))
        want = list(jax_trainer.create_batches(signs, 70, np.random.default_rng((0, epoch))))
        assert len(got) == len(want) > 1 and len(got[-1]) == 70
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for module in (trainer, jax_trainer):
        with pytest.raises(ValueError, match="only one sign"):
            next(module.create_batches(np.ones(10, bool), 4, np.random.default_rng(0)))


def test_adam_matches_optax():
    """Three steps on the same gradients: parameters, moments and the step
    count against optax.adam (float32; the two differ by rounding of the
    bias-correction powers at most, ~1 ulp)."""
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = Adam(tp, 1e-3)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step({k: torch.tensor(v) for k, v in g.items()})
    assert int(opt.count) == int(state[0].count) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(opt.mu[k].numpy(), np.asarray(state[0].mu[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(state[0].nu[k]), rtol=1e-6, atol=0)


def _csv(tmp):
    with open(os.path.join(tmp, "plots", "sdf_net_training.csv")) as f:
        return [line.split() for line in f]


def test_micro_loop_files_csv_and_resume(tmp_path, monkeypatch):
    """One epoch, then ``continue`` to two: the network, table and optimizer
    sidecar every epoch, the per-epoch snapshots, the 4-column CSV whose
    line count is the resume epoch, and both Adams' counts carried over."""
    monkeypatch.chdir(tmp_path)
    first = trainer.train(parse_cli(MICRO + ["epochs=1"]))
    assert first["latent_codes"].shape == (3, 128) and len(first["steps"]) == 1
    for name in (trainer.NET_NAME, LATENT_CODES_FILENAME, trainer.OPT_NAME):
        assert checkpoints.exists(name)
    assert checkpoints.exists(trainer.NET_NAME, epoch=0)
    assert checkpoints.exists(LATENT_CODES_FILENAME, epoch=0)
    rows = _csv(tmp_path)
    assert len(rows) == 1 and len(rows[0]) == 4 and rows[0][0] == "0"

    second = trainer.train(parse_cli(MICRO + ["epochs=2", "continue"]))
    rows = _csv(tmp_path)
    assert [r[0] for r in rows] == ["0", "1"] and all(len(r) == 4 for r in rows)
    assert len(second["steps"]) == 1 and checkpoints.exists(trainer.NET_NAME, epoch=1)
    with np.load(checkpoints.get_filename(trainer.OPT_NAME)) as opt:
        total = sum(first["steps"]) + sum(second["steps"])
        assert int(opt["net/0/count"]) == int(opt["codes/0/count"]) == total
    # The resumed run started from the first run's table, not a fresh draw.
    snapshot = checkpoints.load_array(LATENT_CODES_FILENAME, epoch=0)
    assert not np.array_equal(snapshot, second["latent_codes"].numpy())
    assert np.abs(snapshot - second["latent_codes"].numpy()).max() < 1e-3


def test_resume_refuses_inconsistent_checkpoints(tmp_path, monkeypatch):
    """``continue`` with a network but no latent table raises, and so does a
    table whose row count is not the dataset's shape count."""
    monkeypatch.chdir(tmp_path)
    trainer.train(parse_cli(MICRO + ["epochs=1"]))
    table = checkpoints.load_array(LATENT_CODES_FILENAME)
    os.remove(checkpoints.get_filename(LATENT_CODES_FILENAME))
    with pytest.raises(FileNotFoundError, match="latent"):
        trainer.train(parse_cli(MICRO + ["epochs=2", "continue"]))
    checkpoints.save_array(np.concatenate([table, table]), LATENT_CODES_FILENAME)
    with pytest.raises(ValueError, match="6 rows but the dataset has 3 shapes"):
        trainer.train(parse_cli(MICRO + ["epochs=2", "continue"]))


def test_checkpoints_and_scale_lr_line_interchange_with_jax(tmp_path, monkeypatch, capsys):
    """The same micro run with ``scale_lr`` in both packages: the same
    ``scale_lr`` line; the port's network, table and optimizer sidecar load
    strictly into the JAX package with optax templates; and the port resumes
    from the JAX package's three files."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    monkeypatch.chdir(port_dir)
    trainer.train(parse_cli(MICRO + ["epochs=1", "scale_lr"]))
    port_line = [line for line in capsys.readouterr().out.splitlines() if "scale_lr" in line]

    monkeypatch.chdir(jax_dir)
    jax_trainer.train(JaxTrainConfig(synthetic=3, batch_size=512, epochs=1, nogui=True,
                                     extras={"pointcloud_size": 1024, "scale_lr": True}))
    jax_line = [line for line in capsys.readouterr().out.splitlines() if "scale_lr" in line]
    assert port_line == jax_line and len(port_line) == 1

    # The port's files in the JAX package.
    base = str(port_dir / "models")
    template = jax_trainer.SDFNet().init(jax.random.PRNGKey(0))
    params = jax_checkpoints.load(template, trainer.NET_NAME, base=base, strict=True)
    codes = jax_checkpoints.load_array(LATENT_CODES_FILENAME, base=base)
    tx = optax.adam(1e-5)
    opt_template = {"net": tx.init(template), "codes": tx.init(jnp.asarray(codes))}
    opt = jax_checkpoints.load(opt_template, trainer.OPT_NAME, base=base, strict=True)
    saved = checkpoints.load(trainer.NET_NAME, base=base)
    for key, value in params.items():
        np.testing.assert_array_equal(np.asarray(value), saved[key].numpy())
    assert codes.shape == (3, 128) and int(opt["net"][0].count) == int(opt["codes"][0].count) > 0

    # The JAX package's files in the port: it resumes from them.
    resumed = trainer.train(parse_cli(MICRO + ["epochs=2", "continue", "scale_lr"]))
    assert [r[0] for r in _csv(jax_dir)] == ["0", "1"]
    jax_codes = jax_checkpoints.load_array(LATENT_CODES_FILENAME, epoch=0, base="models")
    assert np.abs(resumed["latent_codes"].numpy() - jax_codes).max() < 1e-3
    with np.load(checkpoints.get_filename(trainer.OPT_NAME)) as sidecar:
        assert int(sidecar["net/0/count"]) > int(opt["net"][0].count)


def test_entry_point_needs_cuda_or_cpu(tmp_path, monkeypatch):
    """Without ``cpu`` the trainer runs on CUDA or raises. ``gui`` is no
    longer refused: with the live viewer a recorder in both packages and
    both resuming epoch 1 from the JAX package's epoch-0 files, the port
    takes the JAX viewer branch: batch by batch, the shape after batch 0
    drawn from the batches' generator between their draws (the same row of
    the table shown), and the epoch's loss of the JAX gui run."""
    import shutil

    from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
    from shapegan_tpu_torch.models.sdf_net import SDFNet

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.train(parse_cli(MICRO[1:] + ["epochs=1"]))
    assert not os.path.exists("models")

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    config = dict(synthetic=3, batch_size=512, extras={"pointcloud_size": 1024})
    jax_trainer.train(JaxTrainConfig(epochs=1, nogui=True, **config))
    shutil.copytree(jax_dir, port_dir)

    shown = {"jax": [], "port": []}

    class Recorder:
        def __init__(self, side):
            self.side = side

        def set_mesh(self, mesh):
            shown[self.side].append(mesh)

        def stop(self):
            shown[self.side].append("stop")

    monkeypatch.setattr(jax_trainer, "make_viewer", lambda nogui: None if nogui else Recorder("jax"))
    monkeypatch.setattr(trainer, "make_viewer", lambda nogui: None if nogui else Recorder("port"))
    monkeypatch.setattr(JaxSDFNet, "get_mesh", lambda self, params, code, **kw: np.asarray(code))
    monkeypatch.setattr(SDFNet, "get_mesh", lambda self, code, **kw: code.detach().numpy())
    jax_trainer.train(JaxTrainConfig(epochs=2, nogui=False, resume=True, **config))
    monkeypatch.chdir(port_dir)
    result = trainer.train(parse_cli(MICRO + ["epochs=2", "continue", "gui"]))

    assert result["shards"] == 1 and len(result["steps"]) == 1
    assert len(shown["port"]) == len(shown["jax"]) == 2 and shown["port"][1] == shown["jax"][1] == "stop"
    np.testing.assert_allclose(shown["port"][0], shown["jax"][0], atol=1e-3)
    losses = [float(_csv(d)[1][2]) for d in (port_dir, jax_dir)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=GUI_LOSS_RTOL)

"""The port's shape-sharded autodecoder epoch against the JAX package's
``make_sharded_epoch`` (a data mesh of 4 virtual CPU devices) and against
the port's one-process epoch on the same global batches: the shard-local
batch draws bit for bit, one SGD step in float32, a four-batch float64
Adam epoch, and the trainer's entry on 2 ranks with its gathered table."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu.parallel.mesh import DATA_AXIS, data_sharding, get_mesh, replicated
from shapegan_tpu.train import sdf_autodecoder as jax_ad
from shapegan_tpu_torch import checkpoints, dryrun_multichip
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.optim import SGD
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks
from shapegan_tpu_torch.train import sdf_autodecoder as ad

SHARDS = 4
MODEL_COUNT, PC_SIZE, LOCAL_BATCH = 4, 256, 64
SGD_ATOL = 1e-5
ADAM_F64_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this process's side, as each spawned rank
    has: under pytest-xdist the workers and their ranks share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("batch_size,shards,seed", [(256, 4, 3), (64, 2, 5), (96, 8, 7)])
def test_create_sharded_batches_bit_equal_to_jax(batch_size, shards, seed):
    signs = np.random.default_rng(seed).random(shards * 200) > 0.4
    got = ad.create_sharded_batches(signs, batch_size, shards, np.random.default_rng(seed))
    want = jax_ad.create_sharded_batches(signs, batch_size, shards, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    assert got.shape[1:] == (shards, batch_size // shards)


@pytest.fixture(scope="module")
def epochs():
    rng = np.random.default_rng(0)
    points = rng.uniform(-1, 1, (MODEL_COUNT * PC_SIZE, 3)).astype(np.float32)
    sdf = np.clip(rng.normal(0, 0.05, MODEL_COUNT * PC_SIZE), -0.1, 0.1).astype(np.float32)
    local_n = MODEL_COUNT * PC_SIZE // SHARDS
    local = rng.integers(0, local_n, (1, SHARDS, LOCAL_BATCH))
    net = JaxSDFNet()
    params = {k: np.asarray(v) for k, v in net.init(jax.random.PRNGKey(0)).items()}
    codes = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (MODEL_COUNT, 128)) * 1e-4)
    ranks = mesh_lib.spawn(rank_checks.autodecoder_epochs, SHARDS, "cpu",
                           args=(params, codes, points, sdf, local, PC_SIZE))
    return {"points": points, "sdf": sdf, "local": local, "params": params, "codes": codes,
            "ranks": ranks, "net": net}


def test_sgd_epoch_matches_jax_sharded_epoch(epochs):
    """The port's ranks against make_sharded_epoch on 4 JAX devices, both in
    float32 (the network gradient summed over data and divided, the code
    gradient divided with no collective)."""
    e = epochs
    mesh = get_mesh(devices=jax.devices()[:SHARDS], data=SHARDS, points=1)
    net_tx, code_tx = optax.sgd(1e-2), optax.sgd(1e-2)
    params = {k: jnp.asarray(v) for k, v in e["params"].items()}
    codes = jnp.asarray(e["codes"])
    code_opt = code_tx.init(codes)
    epoch = jax_ad.make_sharded_epoch(e["net"], net_tx, code_tx, PC_SIZE, mesh, code_opt,
                                      compute_dtype=jnp.float32)
    code_sh = lambda leaf: NamedSharding(mesh, P(DATA_AXIS) if getattr(leaf, "ndim", 0) else P())
    p2, c2, *_ = epoch(jax.device_put(params, replicated(mesh)),
                       jax.device_put(codes, data_sharding(mesh, 2)),
                       jax.device_put(net_tx.init(params), replicated(mesh)),
                       jax.tree.map(lambda l: jax.device_put(l, code_sh(l)), code_opt),
                       jax.device_put(jnp.asarray(e["points"]), data_sharding(mesh, 2)),
                       jax.device_put(jnp.asarray(e["sdf"]), data_sharding(mesh, 1)),
                       jnp.asarray(e["local"], jnp.int32))
    got_codes = np.concatenate([r["codes"] for r in e["ranks"]])
    np.testing.assert_allclose(got_codes, np.asarray(c2), atol=SGD_ATOL)
    for r in e["ranks"]:
        assert np.isfinite(r["losses"]).all()
        for k in e["params"]:
            np.testing.assert_allclose(r["params"][k], np.asarray(p2[k]), atol=SGD_ATOL, err_msg=k)


def test_sgd_epoch_matches_one_process(epochs):
    """The same step in one process over the global batches the shards'
    local batches make."""
    e = epochs
    local_n = MODEL_COUNT * PC_SIZE // SHARDS
    global_batches = (e["local"] + (np.arange(SHARDS) * local_n)[None, :, None]).reshape(1, -1)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in e["params"].items()}
    c = torch.tensor(e["codes"], requires_grad=True)
    losses = ad.run_epoch(p, c, SGD(p, 1e-2), SGD({"codes": c}, 1e-2), torch.tensor(e["points"]),
                          torch.tensor(e["sdf"]), torch.tensor(global_batches), PC_SIZE,
                          apply=sdf_mlp.apply)
    got_codes = np.concatenate([r["codes"] for r in e["ranks"]])
    np.testing.assert_allclose(got_codes, c.detach().numpy(), atol=SGD_ATOL)
    for r in e["ranks"]:
        np.testing.assert_allclose(r["losses"], losses.numpy(), rtol=1e-5)
        for k in p:
            np.testing.assert_allclose(r["params"][k], p[k].detach().numpy(), atol=SGD_ATOL)


def test_float64_adam_epoch_matches_one_process(epochs):
    """The trainer's two Adams over four batches in float64: the shards
    track one process to reduction-order noise."""
    single = rank_checks.to_numpy_tree(
        dryrun_multichip.phase_autodecoder_adam_f64(SHARDS, torch.device("cpu"), False))
    ranks = [r["adam"] for r in epochs["ranks"]]
    err = dryrun_multichip.check(4, ranks, single, SHARDS)
    assert err < ADAM_F64_ATOL


def test_trainer_entry_saves_the_gathered_table(tmp_path):
    """The trainer on 2 ranks (8 shapes: 2 shards of 4) for 2 epochs, then
    ``continue`` to 3: rank 0 saves the whole table in shape order, every
    rank returns it, and the resumed run scatters it back."""
    argv = ["cpu", "synthetic=8", "pointcloud_size=1024", "batch_size=512"]
    runs = [("sdf_autodecoder", argv + ["epochs=2"]),
            ("sdf_autodecoder", argv + ["epochs=3", "continue"])]
    ranks = mesh_lib.spawn(rank_checks.run_trainer, 2, "cpu", args=(runs, str(tmp_path)))
    base = os.path.join(str(tmp_path), "models")
    for run in (0, 1):
        assert [r["runs"][run]["result"]["shards"] for r in ranks] == [2, 2]
        tables = [r["runs"][run]["result"]["latent_codes"] for r in ranks]
        assert tables[0].shape == (8, 128)
        np.testing.assert_array_equal(tables[0], tables[1])
    np.testing.assert_array_equal(checkpoints.load_array(LATENT_CODES_FILENAME, base=base),
                                  ranks[0]["runs"][1]["result"]["latent_codes"])
    np.testing.assert_array_equal(
        checkpoints.load_array(LATENT_CODES_FILENAME, epoch=1, base=base),
        ranks[0]["runs"][0]["result"]["latent_codes"])
    log = (tmp_path / "plots" / "sdf_net_training.csv").read_text().strip().splitlines()
    assert len(log) == 3 and all(np.isfinite(float(line.split()[2])) for line in log)
    saved = np.load(os.path.join(base, "sdf_net_optimizer.npz"))
    assert saved["codes/0/mu"].shape == (8, 128)
    assert int(saved["codes/0/count"]) == int(saved["net/0/count"])

"""The port's data-parallel trainers on gloo ranks against one process:
the classic autoencoder's step with BatchNorm over the global batch, the
point GAN's entry point on 4 ranks through a stage of 8 shapes (4 data
ranks) and a stage of 6 (2 data ranks, 2 idle), and the raymarcher's
frames over two CPU workers."""

import numpy as np
import pytest
import torch

from shapegan_tpu_torch import dryrun_multichip
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.examples import octahedron_params
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks
from shapegan_tpu_torch.render import raymarching as rm
from shapegan_tpu_torch.train import point_gan

WORLD = 4
CURRICULUM = [(64, 8, 3), (64, 6, 3)]
POINT_GAN_ARGV = ["cpu", "synthetic=8", "epochs=3"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this process's side, as each spawned rank
    has: under pytest-xdist the workers and their ranks share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_autoencoder_grads_with_global_batch_norm():
    """The classic AE's loss, gradients and BatchNorm running statistics on
    4 ranks of one volume each against the step on the batch of 4 (the
    dryrun's phase 3 bound for the gradients)."""
    ranks = mesh_lib.spawn(dryrun_multichip.rank_phases, WORLD, "cpu",
                           args=("cpu", (3,)))
    got = [r[3]["result"] for r in ranks]
    single = rank_checks.to_numpy_tree(dryrun_multichip.phase_autoencoder(WORLD, torch.device("cpu"),
                                                                       False))
    assert dryrun_multichip.check(3, got, single, WORLD) < dryrun_multichip.BOUNDS[3]
    for r in got:
        for k, want in single["batch_stats"].items():
            np.testing.assert_allclose(r["batch_stats"][k], want, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.fixture(scope="module")
def point_gan_runs(tmp_path_factory):
    sharded_dir = tmp_path_factory.mktemp("sharded")
    ranks = mesh_lib.spawn(rank_checks.run_trainer, WORLD, "cpu",
                           args=([("point_gan", POINT_GAN_ARGV)], str(sharded_dir), CURRICULUM))
    single_dir = tmp_path_factory.mktemp("single")
    config = parse_cli(POINT_GAN_ARGV, model_dir=str(single_dir / "models"),
                       plot_dir=str(single_dir / "plots"))
    with rank_checks.first_gradients() as grads:
        single = point_gan.train(config, curriculum=CURRICULUM)
    return [r["runs"][0] for r in ranks], single, rank_checks.to_numpy_tree(grads), sharded_dir


def _first_grads_error(got: list, want: list) -> float:
    """The largest error of the optimizers' first gradients, each against
    its one-process counterpart, relative to that counterpart's scale."""
    assert len(got) == len(want)
    return max(dryrun_multichip._relative(a, b) for a, b in zip(got, want))


def test_point_gan_ranks_match_one_process(point_gan_runs):
    """Rank 0's first D and G gradients against one process on the same
    batches and noise (the dryrun's phase 6 bound); every rank ends with
    rank 0's state."""
    runs, single, single_grads, _ = point_gan_runs
    assert _first_grads_error(runs[0]["first_grads"], single_grads) < dryrun_multichip.BOUNDS[6]
    got = {name: runs[0]["result"][name] for name in ("generator", "discriminator")}
    for r in runs[1:]:
        for name in got:
            for k, v in got[name].items():
                np.testing.assert_array_equal(r["result"][name][k], v)


def test_point_gan_idle_ranks_and_files(point_gan_runs):
    """In the stage of 6 shapes only 2 ranks train (6 steps against 3 for
    the idle ones); rank 0 writes the CSV (a line an epoch) and the
    checkpoints."""
    runs, single, _, sharded_dir = point_gan_runs
    ranks = [r["result"] for r in runs]
    assert [r["steps"] for r in ranks] == [6, 6, 3, 3]
    assert single["steps"] == 6
    lines = (sharded_dir / "plots" / "point_gan_training.csv").read_text().strip().splitlines()
    assert [line.split()[:2] for line in lines] == [["64", str(e)] for e in (1, 2, 3)] * 2
    for name in ("point_gan_generator", "point_gan_discriminator", "point_gan_optimizer"):
        assert (sharded_dir / "models" / f"{name}.npz").exists()


def test_render_image_sequence_two_cpu_workers():
    """Two workers on the CPU, each with its own copy of the network, give
    render_image's frames in code order, and on_frame sees each once."""
    net = SDFNet(sdf_mlp.params_from_jax(octahedron_params()))
    codes = [np.random.default_rng(i).normal(size=128).astype(np.float32) for i in range(3)]
    kw = dict(resolution=8, ssaa=1, iterations=8, sdf_offset=0.1)
    want = [rm.render_image(net, c, **kw) for c in codes]
    seen = []
    frames = rm.render_image_sequence(net, codes, devices=["cpu", "cpu"],
                                      on_frame=lambda i, image: seen.append(i),
                                      keep_results=True, **kw)
    assert sorted(seen) == [0, 1, 2]
    for got, w in zip(frames, want):
        np.testing.assert_array_equal(got, w)
    assert rm.render_image_sequence(net, codes, devices="cpu", on_frame=lambda i, im: None,
                                    **kw) is None


def test_autoencoder_entry_on_two_ranks_matches_one_process(tmp_path):
    """The classic AE's entry point on 2 ranks (a batch of 4, 2 rows a
    rank, BatchNorm over the 4) against one process: rank 0's first
    gradients (the dryrun's phase 3 bound), the ranks' equal weights after
    the epoch, and one CSV line written once."""
    from shapegan_tpu_torch.train import autoencoder

    argv = ["cpu", "classic", "synthetic=8", "batch_size=4", "epochs=1"]
    (tmp_path / "sharded").mkdir()
    ranks = mesh_lib.spawn(rank_checks.run_trainer, 2, "cpu",
                           args=([("autoencoder", argv)], str(tmp_path / "sharded")))
    config = parse_cli(argv, model_dir=str(tmp_path / "one" / "models"),
                       plot_dir=str(tmp_path / "one" / "plots"))
    with rank_checks.first_gradients() as grads:
        autoencoder.train(config)
    assert (_first_grads_error(ranks[0]["runs"][0]["first_grads"], rank_checks.to_numpy_tree(grads))
            < dryrun_multichip.BOUNDS[3])
    got = ranks[0]["runs"][0]["result"]["model"]
    for k, v in got.items():
        np.testing.assert_array_equal(ranks[1]["runs"][0]["result"]["model"][k], v)
    lines = (tmp_path / "sharded" / "plots" / "autoencoder_training.csv").read_text().splitlines()
    assert len(lines) == 1

"""The refinement trainer's and the hybrid WGAN's data-parallel branch on
gloo CPU ranks against one process: ``point_gan_ref`` on 4 ranks through a
curriculum stage of 8 shapes (4 data ranks) and one of 6 (2 data ranks, 2
idle), and the hybrid WGAN on 2 ranks, its volumes through
``apply_grid_sharded`` (the one-process side with the ranks' grid math,
``rank_checks.ranks_grid_math``). Each is held to one process by the
gradients its optimizers are handed first."""

import numpy as np
import pytest
import torch

from shapegan_tpu_torch import dryrun_multichip
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks
from shapegan_tpu_torch.train import hybrid_wgan, point_gan_ref

# 8 shapes of 64 points: stage 1 one batch of 8 an epoch (2 rows a rank),
# stage 2 one batch of 6 (3 rows on 2 ranks); 3 epochs each, the G step at
# global step 5 (stage 2's second).
CURRICULUM = [(64, 8, 3), (64, 6, 3)]
REF_ARGV = ["cpu", "synthetic=8", "epochs=3"]
WGAN_ARGV = ["cpu", "synthetic=4", "batch_size=2", "epochs=1"]
# Relative to each optimizer's first gradients' scale. The refinement's
# first D gradients (its bf16 generator and critic, the point GAN's dryrun
# bound) read 8.0e-3; its first G gradients, after four critic steps whose
# first RMSprop moves are about three learning rates whatever a gradient's
# size, 5.7e-2. Every rank on the first rows, or no data mean, read 0.68
# and 0.37. The hybrid WGAN runs float32 reference math on both sides.
REF_BOUNDS = (dryrun_multichip.BOUNDS[6], 0.15)
WGAN_BOUND = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this process's side, as each spawned rank
    has: under pytest-xdist the workers and their ranks share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _first_grads_error(got: list, want: list) -> float:
    assert len(got) == len(want) == 2  # the two optimizers' first steps
    return max(dryrun_multichip._relative(a, b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def refinement_runs(tmp_path_factory):
    sharded = tmp_path_factory.mktemp("sharded")
    ranks = mesh_lib.spawn(rank_checks.run_trainer, 4, "cpu",
                           args=([("point_gan_ref", REF_ARGV, {"curriculum": CURRICULUM})], str(sharded)))
    single = tmp_path_factory.mktemp("single")
    config = parse_cli(REF_ARGV, model_dir=str(single / "models"), plot_dir=str(single / "plots"))
    with rank_checks.first_gradients() as grads:
        result = point_gan_ref.train(config, curriculum=CURRICULUM)
    return [r["runs"][0] for r in ranks], result, rank_checks.to_numpy_tree(grads), sharded


def test_refinement_ranks_match_one_process(refinement_runs):
    """Rank 0's first D gradients (stage 1, 4 data ranks) and first G
    gradients (stage 2, 2 data ranks) against one process; every rank,
    idle ones included, ends with rank 0's networks."""
    runs, _, single_grads, _ = refinement_runs
    assert len(runs[0]["first_grads"]) == len(single_grads) == 2  # D, then G
    for got, want, bound in zip(runs[0]["first_grads"], single_grads, REF_BOUNDS):
        assert dryrun_multichip._relative(got, want) < bound
    want = {name: runs[0]["result"][name] for name in ("generator", "discriminator")}
    for r in runs[1:]:
        for name, params in want.items():
            for k, v in params.items():
                np.testing.assert_array_equal(r["result"][name][k], v, err_msg=k)


def test_refinement_idle_ranks_keep_the_step_count_and_rank_zero_writes(refinement_runs):
    """The stage of 6 trains on 2 ranks (6 steps against 3 for the idle
    ones, whose step count still reaches the G step of the same global
    step); rank 0 alone writes the CSV (a line an epoch) and the files."""
    runs, single, _, sharded = refinement_runs
    assert [r["result"]["steps"] for r in runs] == [6, 6, 3, 3]
    assert single["steps"] == 6
    assert [len(r["result"]["g_step_s"]) for r in runs] == [1, 1, 0, 0]
    lines = (sharded / "plots" / "point_gan_ref_training.csv").read_text().splitlines()
    assert [line.split()[:2] for line in lines] == [["64", str(e)] for e in (1, 2, 3)] * 2
    for r in runs[1:]:
        assert r["written"] == []
    for name in (point_gan_ref.G_NAME, point_gan_ref.D_NAME, point_gan_ref.OPT_NAME):
        assert f"models/{name}.npz" in runs[0]["written"]


def test_hybrid_wgan_entry_on_two_ranks_matches_one_process(tmp_path):
    """The hybrid WGAN's entry point on 2 ranks (synthetic=4, batch 2, one
    row a rank): every critic and G step's volumes through
    apply_grid_sharded, rank 0's first critic and G gradients against one
    process, equal generators after the epoch, and the files written by
    rank 0 alone."""
    (tmp_path / "sharded").mkdir()
    ranks = mesh_lib.spawn(rank_checks.run_trainer, 2, "cpu",
                           args=([("hybrid_wgan", WGAN_ARGV)], str(tmp_path / "sharded")))
    config = parse_cli(WGAN_ARGV, model_dir=str(tmp_path / "one" / "models"),
                       plot_dir=str(tmp_path / "one" / "plots"))
    with rank_checks.ranks_grid_math(), rank_checks.first_gradients() as grads:
        hybrid_wgan.train(config)
    runs = [r["runs"][0] for r in ranks]
    # Two critic steps and one G step an epoch, each a sharded evaluation.
    assert [r["sharded_calls"] for r in runs] == [3, 3]
    assert _first_grads_error(runs[0]["first_grads"], rank_checks.to_numpy_tree(grads)) < WGAN_BOUND
    for k, v in runs[0]["result"]["net"].items():
        np.testing.assert_array_equal(runs[1]["result"]["net"][k], v)
    assert runs[1]["written"] == []
    for name in (hybrid_wgan.G_NAME, hybrid_wgan.D_NAME, hybrid_wgan.OPT_NAME):
        assert f"models/{name}.npz" in runs[0]["written"]
    assert len((tmp_path / "sharded" / "plots" / "hybrid_wgan_training.csv")
               .read_text().splitlines()) == 1


def test_refinement_check_fails_with_every_rank_on_the_first_rows(tmp_path, refinement_runs):
    """On a mesh that gives every rank data row 0's slice of each batch (the
    replicas stay equal), rank 0's first D and G gradients leave their
    bounds."""
    _, _, single_grads, _ = refinement_runs
    ranks = mesh_lib.spawn(rank_checks.broken, 4, "cpu",
                           args=("first_rows", rank_checks.run_trainer,
                                 [("point_gan_ref", REF_ARGV, {"curriculum": CURRICULUM})], str(tmp_path)))
    for got, want, bound in zip(ranks[0]["runs"][0]["first_grads"], single_grads, REF_BOUNDS):
        assert dryrun_multichip._relative(got, want) > bound

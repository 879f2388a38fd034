"""The hybrid GAN's data-parallel trainer on 2 gloo CPU ranks against one
process: ``make_steps`` under a data mesh (the G step through the sharded
trainable grid evaluation, the D step's fakes through the sharded forward,
both gradients averaged over the data group), and the trainer's entry
point (the mesh branch of ``train``, each rank on its rows of the voxel
batches). The one-process side evaluates the grid as a rank does on the
CPU (``rank_checks.ranks_grid_math``), so the two differ by reduction
order only."""

import numpy as np
import pytest
import torch

from shapegan_tpu_torch import dryrun_multichip
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks
from shapegan_tpu_torch.train import hybrid_gan

WORLD = 2
# Relative to each optimizer's first gradients' scale. Reduction order
# read 1e-6 (make_steps) and 3.8e-4 (the entry point's D gradients, one
# Adam step of G after the start); every rank on the first rows of the
# batch moves the G step's by 0.11.
GRAD_BOUND = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this process's side, as each spawned rank
    has: under pytest-xdist the workers and their ranks share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _first_grads_error(got: list, want: list) -> float:
    assert len(got) == len(want) == 2  # the G optimizer's, then the D optimizer's
    return max(dryrun_multichip._relative(a, b) for a, b in zip(got, want))


def test_hybrid_gan_steps_on_a_data_mesh_match_one_process():
    """Two step pairs on 2 ranks (a global batch of 4, 2 rows a rank): the
    G and D optimizers' first gradients against one process, every G and D
    step through apply_grid_sharded, the replicas equal, the metrics
    averaged to the one-process metrics."""
    ranks = mesh_lib.spawn(rank_checks.hybrid_gan_steps, WORLD, "cpu")
    single = rank_checks.to_numpy_tree(rank_checks.hybrid_gan_pair(WORLD, False))
    assert single["sharded_calls"] == 0
    assert _first_grads_error(ranks[0]["first_grads"], single["first_grads"]) < GRAD_BOUND
    for r in ranks:
        assert r["sharded_calls"] == 4
        for key in ("pred_fake", "pred_real"):
            np.testing.assert_allclose(r["metrics"][key], single["metrics"][key], rtol=1e-5)
        for net in ("g", "d"):
            for k, v in ranks[0][net].items():
                np.testing.assert_array_equal(r[net][k], v)


def test_hybrid_gan_entry_on_two_ranks_matches_one_process(tmp_path):
    """The entry point on 2 ranks (synthetic=4, batch 2, one row a rank):
    rank 0's first G and D gradients against one process, the ranks' equal
    generators after the epoch, and one CSV line and the checkpoints
    written once."""
    argv = ["cpu", "synthetic=4", "batch_size=2", "epochs=1"]
    (tmp_path / "sharded").mkdir()
    ranks = mesh_lib.spawn(rank_checks.run_trainer, WORLD, "cpu",
                           args=([("hybrid_gan", argv)], str(tmp_path / "sharded")))
    config = parse_cli(argv, model_dir=str(tmp_path / "one" / "models"),
                       plot_dir=str(tmp_path / "one" / "plots"))
    with rank_checks.ranks_grid_math(), rank_checks.first_gradients() as grads:
        hybrid_gan.train(config)
    runs = [r["runs"][0] for r in ranks]
    assert _first_grads_error(runs[0]["first_grads"], rank_checks.to_numpy_tree(grads)) < GRAD_BOUND
    for k, v in runs[0]["result"]["net"].items():
        np.testing.assert_array_equal(runs[1]["result"]["net"][k], v)
    lines = (tmp_path / "sharded" / "plots" / "hybrid_gan_training.csv").read_text().splitlines()
    assert len(lines) == 1
    assert (tmp_path / "sharded" / "models" / "hybrid_gan_generator.npz").exists()

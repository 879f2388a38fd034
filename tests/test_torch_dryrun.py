"""The port's multichip dryrun on 4 gloo CPU ranks: all six phases pass
against one process, and on a mesh broken on purpose (no data-axis
gradient mean; every rank on the first rows of a batch) its phases fail."""

import pytest
import torch

from shapegan_tpu_torch import dryrun_multichip
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks

WORLD = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this process's side, as each spawned rank
    has: under pytest-xdist the workers and their ranks share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dryrun_multichip_four_cpu_ranks():
    lines = []
    out = dryrun_multichip.dryrun_multichip(4, "cpu", log=lines.append)
    assert sorted(out["errors"]) == list(dryrun_multichip.PHASES)
    for phase, err in out["errors"].items():
        assert err < dryrun_multichip.BOUNDS[phase]
    assert [line.split()[2] for line in lines] == [f"{p}/6" for p in dryrun_multichip.PHASES]
    # No rank launched a CUDA kernel on the CPU.
    assert all(sum(c.values()) == 0 for rank in out["counts"] for c in rank.values())


# The phases each planted fault must fail.
FAULT_PHASES = {"no_data_mean": (1, 3), "first_rows": (1, 5, 6)}


@pytest.fixture(scope="module")
def broken_ranks():
    """Each fault's phases on 4 ranks of a broken mesh, spawned once a fault."""
    runs = {}

    def ranks(fault):
        if fault not in runs:
            runs[fault] = mesh_lib.spawn(rank_checks.broken, WORLD, "cpu",
                                         args=(fault, dryrun_multichip.rank_phases, "cpu",
                                               FAULT_PHASES[fault]))
        return runs[fault]

    return ranks


def _check_broken(ranks, phase: int) -> float:
    """The phase's results on the broken mesh against one process."""
    single = rank_checks.to_numpy_tree(
        dryrun_multichip.PHASE_FUNCTIONS[phase](WORLD, torch.device("cpu"), False))
    return dryrun_multichip.check(phase, [r[phase]["result"] for r in ranks], single, WORLD)


@pytest.mark.parametrize("phase", FAULT_PHASES["no_data_mean"])
def test_dryrun_fails_without_the_data_mean(phase, broken_ranks):
    """A mesh whose gradient mean over the data group does nothing: the
    progressive step pair (data 2 x points 2) and the autoencoder phase
    must fail."""
    with pytest.raises(AssertionError, match=f"phase {phase}"):
        _check_broken(broken_ranks("no_data_mean"), phase)


@pytest.mark.parametrize("phase", FAULT_PHASES["first_rows"])
def test_dryrun_fails_with_every_rank_on_the_first_rows(phase, broken_ranks):
    """A mesh that gives every rank data row 0's slice of each batch: the
    replicas stay equal and the runs stay finite, yet the step pair, the
    chain (compared on its third pair's gradients) and the point GAN must
    fail against one process."""
    with pytest.raises(AssertionError, match=f"phase {phase}: sharded against one process"):
        _check_broken(broken_ranks("first_rows"), phase)

"""The voxel GAN, WGAN and classifier trainers' data-parallel branch on 2
gloo CPU ranks against one process: the gradients each optimizer is handed
at its first step, the generators' BatchNorm running statistics (global
batch statistics on every rank), the files written by rank 0 alone, and
planted faults (every rank on the first rows; no data mean) that break the
gradient check."""

import numpy as np
import pytest
import torch

from shapegan_tpu_torch import dryrun_multichip
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks
from shapegan_tpu_torch.train import classifier, gan, wgan

WORLD = 2
# A batch of 4, 2 rows a rank, one step an epoch (the WGAN: a critic step,
# then its generator step).
RUNS = [("gan", ["cpu", "synthetic=4", "batch_size=4", "epochs=1"]),
        ("wgan", ["cpu", "synthetic=4", "batch_size=4", "epochs=1"]),
        ("classifier", ["cpu", "synthetic=1", "batch_size=4", "epochs=1"])]
TRAINERS = {"gan": gan, "wgan": wgan, "classifier": classifier}
FILES = {"gan": ("plots/gan_training.csv", "models/generator.npz", "models/discriminator.npz"),
         "wgan": ("plots/wgan_training.csv", "models/wgan-generator.npz",
                  "models/wgan-critic.npz"),
         "classifier": ("plots/classifier_training.csv", "models/classifier.npz",
                        "models/classifier_optimizer.npz")}
# Relative to each optimizer's first gradients' scale. Reduction order read
# 2.4e-6 (the GAN's G), 4.5e-4 (its D, one Adam step of G after the start),
# below 2e-6 for the WGAN and the classifier; every rank on the first rows,
# or no data mean, moved them by 0.13 to 6.4.
GRAD_BOUND = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this process's side, as each spawned rank
    has: under pytest-xdist the workers and their ranks share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _one_process(tmp_path) -> dict:
    out = {}
    for name, argv in RUNS:
        config = parse_cli(argv, model_dir=str(tmp_path / name / "models"),
                           plot_dir=str(tmp_path / name / "plots"))
        with rank_checks.first_gradients() as grads:
            result = TRAINERS[name].train(config)
        out[name] = {"first_grads": rank_checks.to_numpy_tree(grads),
                     "result": rank_checks.to_numpy_tree(rank_checks._summary(result))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sharded = tmp_path_factory.mktemp("sharded")
    ranks = mesh_lib.spawn(rank_checks.run_trainer, WORLD, "cpu", args=(RUNS, str(sharded)))
    got = {name: [r["runs"][i] for r in ranks] for i, (name, _) in enumerate(RUNS)}
    return got, _one_process(tmp_path_factory.mktemp("single")), sharded


def _first_grads_error(got: list, want: list) -> float:
    assert len(got) == len(want) == 2  # the two optimizers' first steps
    return max(dryrun_multichip._relative(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", list(TRAINERS))
def test_first_gradients_match_one_process(runs, name):
    """Rank 0's first G and D gradients (the classifier's one optimizer's
    first) against one process on the same batch and latents; the ranks
    end with equal parameters."""
    got, single, _ = runs
    if name == "classifier":
        assert len(got[name][0]["first_grads"]) == len(single[name]["first_grads"]) == 1
        err = dryrun_multichip._relative(got[name][0]["first_grads"][0],
                                         single[name]["first_grads"][0])
    else:
        err = _first_grads_error(got[name][0]["first_grads"], single[name]["first_grads"])
    assert err < GRAD_BOUND, err
    for key, params in got[name][0]["result"].items():
        if isinstance(params, dict):
            for k, v in params.items():
                np.testing.assert_array_equal(got[name][1]["result"][key][k], v, err_msg=k)


@pytest.mark.parametrize("name, key", [("gan", "generator"), ("wgan", "generator")])
def test_generator_batch_norm_statistics_are_the_global_batch(runs, name, key):
    """The generator's BatchNorm running statistics after the epoch: equal
    on both ranks and to one process's on the batch of 4."""
    got, single, _ = runs
    want = single[name]["result"][key]
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    assert stats
    for r in got[name]:
        for k in stats:
            np.testing.assert_allclose(r["result"][key][k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("name", list(TRAINERS))
def test_rank_zero_alone_writes_the_files(runs, name):
    """Rank 0 wrote the CSV (one line for the epoch) and the checkpoints;
    rank 1 wrote nothing."""
    got, _, sharded = runs
    rank0, rank1 = (r["written"] for r in got[name])
    assert rank1 == []
    for path in FILES[name]:
        assert path in rank0, (path, rank0)
    lines = (sharded / FILES[name][0]).read_text().splitlines()
    assert len(lines) == 1 and lines[0].split()[0] == "0"


@pytest.mark.parametrize("fault", ["first_rows", "no_data_mean"])
def test_planted_faults_break_the_gradient_check(tmp_path, fault, runs):
    """On a mesh broken on purpose the GAN's and the classifier's first
    gradients on rank 0 leave the bound."""
    _, single, _ = runs
    broken = [RUNS[0], RUNS[2]]
    ranks = mesh_lib.spawn(rank_checks.broken, WORLD, "cpu",
                           args=(fault, rank_checks.run_trainer, broken, str(tmp_path)))
    gan_err = _first_grads_error(ranks[0]["runs"][0]["first_grads"], single["gan"]["first_grads"])
    cls_err = dryrun_multichip._relative(ranks[0]["runs"][1]["first_grads"][0],
                                         single["classifier"]["first_grads"][0])
    assert gan_err > GRAD_BOUND and cls_err > GRAD_BOUND, (gan_err, cls_err)

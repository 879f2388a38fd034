"""The whole pipeline, prepare → train → evaluate, on a corpus of
pathological meshes (counterpart of the root ``run_fixture_corpus.py``).

    python -m shapegan_tpu_torch.run_fixture_corpus [workdir] [count=12] [epochs=3] \\
        [ad_epochs=40] [overfit_epochs=150] [recon_max=..] [mmd_max=..] \\
        [cov_min=..] [overfit_max=..] [cpu]

The corpus comes from :mod:`shapegan_tpu_torch.data.fixtures` (open shells,
double walls, self-intersecting unions, degenerate soups, chair-likes,
watertight controls: what ShapeNetCore.v2 holds), so nothing downloads.
Stages, the first three idempotent:

  1. write the corpus's ``.obj`` files;
  2. prepare them (voxels 8, 16, 32; uniform and surface samples 16,384;
     DeepSDF clouds 50,000; scan signs, ``.badmesh`` quarantine);
  3. combine the clouds and write the splits;
  4. train the classic autoencoder on ``voxels_32`` (cuDNN);
  5. train the DeepSDF autodecoder on the combined cloud (the rowwise
     kernels B6a and B6b on the GPU);
  6. dump the autoencoder's reconstructions of four shapes
     (``plots/fixture_reconstructions.npy``) with text slices;
  7. the quality gate: every trained shape reconstructed from its latent
     code (``SDFNet.get_mesh`` at 64^3: the points kernel B3 once a mesh on
     the GPU), its Chamfer distance to ground-truth surface samples of its
     mesh, MMD-CD and COV-CD of the reconstructions against the corpus (an
     empty mesh stands in as a far-away dummy cloud), and one shape
     overfit alone; the bars of :data:`DEFAULT_GATES`. The record goes to
     ``<workdir>/gate_autodecoder.json`` and is printed as one ``GATE
     {...}`` line.

It runs on the GPU unless given ``cpu`` (without CUDA it fails). Exit
codes: 0 when every bar holds; :data:`BARS_FAILED` (3) when the run was
sound and a bar failed (the JAX script exits 1 then, like a crash); a
crash, or a non-finite training log, raises and exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from shapegan_tpu_torch.core.config import TrainConfig, resolve_device

# The JAX script's bars, calibrated on its corpus run (count=12 epochs=3
# ad_epochs=40 overfit_epochs=150), unchanged.
DEFAULT_GATES = {
    "recon_max": 0.020,    # mean per-shape reconstruction Chamfer (squared distances)
    "mmd_max": 0.020,      # MMD-CD of the reconstructions against the corpus
    "cov_min": 0.5,        # COV-CD: the reconstructions cover at least half the corpus
    "overfit_max": 0.010,  # the single-shape overfit's reconstruction Chamfer
}
BARS_FAILED = 3


def main(argv: Optional[List[str]] = None) -> int:
    """Parse the JAX script's command line and run; returns the exit code
    (0, or :data:`BARS_FAILED`)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = dict(a.split("=", 1) for a in argv if "=" in a)
    words = [a for a in argv if "=" not in a]
    cpu = "cpu" in words
    words = [w for w in words if w != "cpu"]
    record = run(
        words[0] if words else "fixture_corpus_run",
        count=int(opts.get("count", 12)),
        epochs=int(opts.get("epochs", 3)),
        ad_epochs=int(opts["ad_epochs"]) if "ad_epochs" in opts else None,
        overfit_epochs=int(opts.get("overfit_epochs", 150)),
        gates={k: float(opts[k]) for k in DEFAULT_GATES if k in opts},
        device=resolve_device(TrainConfig(cpu=cpu)),
    )
    if record["failures"]:
        print(f"QUALITY GATE FAILED: {', '.join(record['failures'])}", file=sys.stderr)
        return BARS_FAILED
    print("quality gate: PASS")
    return 0


def run(workdir, count=12, epochs=3, uniform_count=16384, cloud_count=50000,
        voxel_resolutions=(8, 16, 32), ad_epochs=None, overfit_epochs=150, gates=None,
        mesh_resolution=64, device="cuda") -> dict:
    """Run the seven stages in ``workdir`` on ``device``, the gate's meshes
    at ``mesh_resolution``^3; returns the gate's record (``quality``,
    ``thresholds``, ``config``, ``pass``, ``failures``, and the ``device``
    and stage ``timings``)."""
    from shapegan_tpu_torch.data.datasets import VoxelDataset
    from shapegan_tpu_torch.data.fixtures import make_fixture_corpus
    from shapegan_tpu_torch.data.prepare import (
        PrepareConfig,
        combine_sdf_clouds,
        process_mesh_files,
        write_split_file,
    )
    from shapegan_tpu_torch.train import autoencoder as ae
    from shapegan_tpu_torch.train import sdf_autodecoder as ad
    from shapegan_tpu_torch.util import create_text_slice

    device = torch.device(device)
    cpu = device.type == "cpu"
    os.makedirs(workdir, exist_ok=True)
    data_dir = os.path.join(workdir, "data")
    model_dir = os.path.join(workdir, "models")
    plot_dir = os.path.join(workdir, "plots")
    timings = {}

    # 1-2. the corpus, prepared
    t0 = time.time()
    paths = make_fixture_corpus(os.path.join(workdir, "meshes"), count=count, seed=0)
    config = PrepareConfig(output_dir=os.path.join(data_dir, "fixtures"),
                           voxel_resolutions=list(voxel_resolutions), uniform_count=uniform_count,
                           surface_count=uniform_count, cloud_count=cloud_count)
    results = process_mesh_files(paths, config)
    timings["prepare"] = time.time() - t0
    n_ok = results.count("ok") + results.count("skipped")
    n_bad = results.count("bad")

    # 3. combined cloud and splits
    t0 = time.time()
    combine_sdf_clouds(config, out_dir=data_dir)
    write_split_file(config, train_fraction=0.9)
    timings["combine"] = time.time() - t0

    # 4. the classic autoencoder on the corpus's 32^3 voxels
    t0 = time.time()
    os.makedirs(plot_dir, exist_ok=True)
    model = ae.train(TrainConfig(classic=True, epochs=epochs, seed=0, data_dir=data_dir,
                                 category="fixtures", model_dir=model_dir, plot_dir=plot_dir,
                                 cpu=cpu))["model"]
    _assert_finite_csv(os.path.join(plot_dir, "autoencoder_training.csv"))
    timings["train_ae"] = time.time() - t0

    # 5. the autodecoder on the combined cloud (an epoch is ~30 steps here:
    # the gate needs more of them than `epochs`)
    t0 = time.time()
    result = ad.train(TrainConfig(epochs=ad_epochs if ad_epochs is not None else max(epochs, 40),
                                  seed=0, data_dir=data_dir, model_dir=model_dir,
                                  plot_dir=plot_dir, cpu=cpu,
                                  extras={"pointcloud_size": str(config.cloud_count)}))
    _assert_finite_csv(os.path.join(plot_dir, "sdf_net_training.csv"))
    timings["train_autodecoder"] = time.time() - t0

    # 6. the autoencoder's reconstructions
    t0 = time.time()
    dataset = VoxelDataset.glob(os.path.join(config.output_dir, "voxels_32", "*.npy"))
    batch = np.stack([dataset[i] for i in range(min(4, len(dataset)))])
    with torch.no_grad():
        recon = model(torch.tensor(batch, device=device), train=False).cpu().numpy()
    for name, volume in (("data", batch[0]), ("reconstruction", recon[0])):
        print(f"--- {name} slice ---")
        print(create_text_slice(volume))
    np.save(os.path.join(plot_dir, "fixture_reconstructions.npy"), recon)
    timings["plot"] = time.time() - t0

    # 7. the quality gate
    t0 = time.time()
    thresholds = dict(DEFAULT_GATES)
    thresholds.update(gates or {})
    quality = quality_gate(workdir, config, result["net"], result["latent_codes"],
                           overfit_epochs=overfit_epochs, mesh_resolution=mesh_resolution,
                           device=device)
    timings["quality_gate"] = time.time() - t0

    print("\n=== fixture corpus pipeline summary ===")
    print(f"meshes: {count} written, {n_ok} prepared, {n_bad} quarantined (.badmesh)")
    for res in config.voxel_resolutions:
        print(f"voxels_{res}: {len(os.listdir(os.path.join(config.output_dir, f'voxels_{res}')))} files")
    for sub in ("uniform", "surface", "cloud"):
        print(f"{sub}: {len(os.listdir(os.path.join(config.output_dir, sub)))} files")
    points = np.load(os.path.join(data_dir, "sdf_points.npy"), mmap_mode="r")
    print(f"combined cloud: {points.shape[0]} points")
    for k, v in timings.items():
        print(f"{k}: {v:.1f}s")

    print("\n=== quality gate ===")
    failures = evaluate_gates(quality, thresholds, verbose=True)
    if quality["empty_meshes"]:
        print(f"note: {quality['empty_meshes']} latent codes decoded to empty meshes")
    record = {
        "gate": "autodecoder",
        "quality": quality,
        "thresholds": thresholds,
        "config": {"count": count, "epochs": epochs, "ad_epochs": ad_epochs,
                   "overfit_epochs": overfit_epochs},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "timings": timings,
        "pass": not failures,
        "failures": failures,
    }
    with open(os.path.join(workdir, "gate_autodecoder.json"), "w") as f:
        json.dump(record, f, indent=1)
    print("GATE " + json.dumps(record), flush=True)
    return record


def evaluate_gates(quality: dict, thresholds: dict, verbose: bool = False) -> List[str]:
    """The names of the metrics that miss their bars (none: the gate
    passes)."""
    checks = (
        ("recon_chamfer", quality["recon_chamfer"], "<=", thresholds["recon_max"]),
        ("mmd_cd", quality["mmd_cd"], "<=", thresholds["mmd_max"]),
        ("cov_cd", quality["cov_cd"], ">=", thresholds["cov_min"]),
        ("overfit_chamfer", quality["overfit_chamfer"], "<=", thresholds["overfit_max"]),
    )
    failures = []
    for name, value, op, bound in checks:
        ok = value <= bound if op == "<=" else value >= bound
        if verbose:
            print(f"{name}: {value:.5f} ({op} {bound:g}) {'PASS' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    return failures


def quality_gate(workdir, config, net, latent_codes, overfit_epochs=150, point_count=2048,
                 mesh_resolution=64, device="cuda") -> dict:
    """Chamfer, MMD-CD and COV-CD of the autodecoder's reconstructions
    against ground-truth surface samples of the corpus's meshes, and the
    reconstruction Chamfer of one shape overfit alone. Both sides are
    rescaled into the half-unit sphere (``metrics.rescale_point_cloud``)."""
    from shapegan_tpu_torch.data.mesh_io import load_mesh
    from shapegan_tpu_torch.metrics import chamfer_distance, pairwise_chamfer, rescale_point_cloud
    from shapegan_tpu_torch.train import sdf_autodecoder as ad

    # The combined cloud's shape order is the sorted cloud ids.
    cloud_dir = os.path.join(config.output_dir, "cloud")
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(cloud_dir) if f.endswith(".npy"))
    mesh_dir = os.path.join(workdir, "meshes")
    gt = np.stack([rescale_point_cloud(load_mesh(os.path.join(mesh_dir, stem + ".obj"))
                                       .sample(point_count, seed=i))
                   for i, stem in enumerate(stems)])

    def reconstruct(sdf_net, code, seed):
        mesh = sdf_net.get_mesh(code, voxel_resolution=mesh_resolution)
        return None if mesh is None else rescale_point_cloud(mesh.sample(point_count, seed=seed))

    recon, empty = [], 0
    for i in range(len(stems)):
        cloud = reconstruct(net, latent_codes[i], seed=100 + i)
        if cloud is None:
            # An empty decode is maximally bad: a far-away dummy cloud is
            # punished by the scores instead of skipped.
            empty += 1
            cloud = np.full((point_count, 3), 10.0, np.float32)
        recon.append(cloud)
    d = pairwise_chamfer(np.stack(recon), gt, device)
    recon_chamfer = float(np.mean(np.diag(d)))
    mmd_cd = float(d.min(axis=0).mean())
    cov_cd = float(len(np.unique(d.argmin(axis=1))) / len(gt))

    # The single-shape overfit: shape 0's rows of the combined cloud,
    # trained alone long enough to overfit.
    overfit_dir = os.path.join(workdir, "overfit")
    os.makedirs(overfit_dir, exist_ok=True)
    n = config.cloud_count
    for name in ("sdf_points.npy", "sdf_values.npy"):
        rows = np.load(os.path.join(workdir, "data", name), mmap_mode="r")[:n]
        np.save(os.path.join(overfit_dir, name), np.asarray(rows))
    device = torch.device(device)
    result = ad.train(TrainConfig(epochs=overfit_epochs, seed=0, data_dir=overfit_dir,
                                  model_dir=os.path.join(overfit_dir, "models"),
                                  plot_dir=os.path.join(overfit_dir, "plots"),
                                  cpu=device.type == "cpu", extras={"pointcloud_size": str(n)}))
    of_cloud = reconstruct(result["net"], result["latent_codes"][0], seed=999)
    overfit_chamfer = (float("inf") if of_cloud is None
                       else float(chamfer_distance(of_cloud, gt[0], device)))
    return {"recon_chamfer": recon_chamfer, "mmd_cd": mmd_cd, "cov_cd": cov_cd,
            "overfit_chamfer": overfit_chamfer, "empty_meshes": empty}


def _assert_finite_csv(path: str) -> None:
    """Every logged epoch of a trainer's CSV must be finite; raises
    AssertionError otherwise."""
    values = np.loadtxt(path, ndmin=2)
    if values.shape[0] == 0 or not np.all(np.isfinite(values)):
        raise AssertionError(f"empty or non-finite training log {path}")


if __name__ == "__main__":
    sys.exit(main())

"""GAN-family quality gate: train, sample, score and picture the GANs
(counterpart of the root ``run_gan_gate.py``).

    python -m shapegan_tpu_torch.gan_gate [workdir] [cpu] [shapes=64] [samples=16] \\
        [gan_epochs=2000] [prog_epochs=250] [point_count=2048] [gt_count=24] \\
        [prog_g_every=1] [prog_lr=1e-3] [prog_d_lr=..] [save_every=25] [nosheet] \\
        [continue] [voxel_mmd_max=..] [voxel_cov_min=..] [prog_mmd_max=..] [prog_cov_min=..]

The JAX gate's stages, on the port:

  * ground truth: surface clouds of the first ``gt_count`` synthetic
    training shapes at 64^3 (``make_voxel_dataset``, not rescaled);
  * the voxel GAN (``train.gan``, batch 32) on ``shapes`` synthetic shapes
    for ``gan_epochs``, then ``samples`` volumes from its generator in eval
    mode, meshed and sampled;
  * the progressive hybrid WGAN-GP's chain 0 → 1 → 2 → 3 (8^3 … 64^3,
    ``train.hybrid_progressive_gan``, batch 16, ``prog_epochs`` an
    iteration, the generator updated every ``prog_g_every`` batches at
    ``prog_lr``), each iteration warm-started from the last one's files and
    its CSV checked finite, then ``samples`` meshes of the 64^3 generator;
  * MMD-CD and COV-CD of both against the ground truth, empty samples
    replaced by a far-away cloud first (:func:`_punish_empty`);
  * the sample sheet ``plots/gan_shapes.png``: a row of dataset shapes, of
    voxel-GAN samples and of progressive samples, through the headless
    viewer;
  * the record ``<workdir>/gate_gan.json``, also printed as one ``GATE
    {...}`` line: the metrics, ``thresholds``, ``config``, ``pass``,
    ``failures`` and the ``device`` it ran on.

``continue`` resumes each training stage from its own files once it has
started. On the GPU the progressive chain runs the grid kernel and the grid
backward kernel, and every mesh of the SDF generator the points kernel.

Latents differ from the JAX gate's keys: the voxel GAN's samples and the
progressive codes come from CPU ``torch.Generator`` streams seeded with
``seed + 7`` and ``seed + 11`` (the JAX gate's ``PRNGKey(seed + 7)`` and
``PRNGKey(seed + 11)``), so the CPU and the GPU draw the same latents.

Exit codes: 0 when every bar holds; :data:`BARS_FAILED` (3) when the run was
sound but a bar failed (the JAX gate exits 1 then, like a crash); a crash or
a non-finite training log raises, which exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, checkpoints
from shapegan_tpu_torch.core.config import TrainConfig, resolve_device
from shapegan_tpu_torch.metrics import (
    coverage,
    minimum_matching_distance,
    sample_from_voxels,
    sample_point_clouds,
)
from shapegan_tpu_torch.render.png import write_png
from shapegan_tpu_torch.render.viewer import MeshRenderer

# The JAX gate's bars (run_gan_gate.py DEFAULT_GATES), unchanged.
DEFAULT_GATES = {
    "voxel_mmd_max": 0.010,
    "voxel_cov_min": 0.30,
    "prog_mmd_max": 0.010,
    "prog_cov_min": 0.30,
}
BARS_FAILED = 3


def main(argv: Optional[List[str]] = None) -> int:
    """Parse the JAX gate's command line, run the gate; returns the exit
    code (0, or :data:`BARS_FAILED`)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = dict(a.split("=", 1) for a in argv if "=" in a)
    words = [a for a in argv if "=" not in a]
    flags = {w for w in words if w in ("cpu", "nosheet", "continue")}
    words = [w for w in words if w not in flags]
    device = resolve_device(TrainConfig(cpu="cpu" in flags))
    record = run(
        words[0] if words else "gan_gate_run",
        shapes=int(opts.get("shapes", 64)),
        samples=int(opts.get("samples", 16)),
        gan_epochs=int(opts.get("gan_epochs", 2000)),
        prog_epochs=int(opts.get("prog_epochs", 250)),
        point_count=int(opts.get("point_count", 2048)),
        gt_count=int(opts.get("gt_count", 24)),
        sheet="nosheet" not in flags,
        gates={k: float(opts[k]) for k in DEFAULT_GATES if k in opts},
        resume="continue" in flags,
        save_every=int(opts.get("save_every", 25)),
        prog_g_every=int(opts.get("prog_g_every", 1)),
        prog_lr=float(opts.get("prog_lr", 1e-3)),
        prog_d_lr=float(opts["prog_d_lr"]) if "prog_d_lr" in opts else None,
        device=device,
    )
    if record["failures"]:
        print(f"GAN QUALITY GATE FAILED: {', '.join(record['failures'])}", file=sys.stderr)
        return BARS_FAILED
    print("GAN quality gate: PASS")
    return 0


def run(workdir, shapes=64, samples=16, gan_epochs=2000, prog_epochs=250, point_count=2048,
        gt_count=24, mesh_resolution=64, sheet=True, gates=None, seed=0, resume=False,
        save_every=25, prog_g_every=1, prog_lr=1e-3, prog_d_lr=None, device="cuda") -> dict:
    """Train, sample, score and picture both GAN families in ``workdir``;
    returns the record. ``resume`` continues each training stage from its
    own CSV and files once it has started; ``save_every`` thins the latest
    slots' saves (a retry loses at most ``save_every - 1`` epochs)."""
    from shapegan_tpu_torch.data.synthetic import make_voxel_dataset
    from shapegan_tpu_torch.train import gan
    from shapegan_tpu_torch.train import hybrid_progressive_gan as prog

    device = torch.device(device)
    cpu = device.type == "cpu"
    plot_dir = os.path.join(workdir, "plots")
    model_dir = os.path.join(workdir, "models")
    os.makedirs(plot_dir, exist_ok=True)
    timings = {}

    def stage_resume(csv_name):
        # Resume a stage only once it has started: an iteration that never
        # ran must take the warm start from the previous one.
        return resume and os.path.exists(os.path.join(plot_dir, csv_name))

    t0 = time.time()
    gt_count = min(gt_count, shapes)
    gt_voxels = make_voxel_dataset(gt_count, 64, rescale=False, seed=seed)
    gt_clouds = sample_from_voxels(gt_voxels, point_count=point_count, seed=seed, device=device)
    timings["ground_truth"] = time.time() - t0

    # --- A. voxel GAN ---------------------------------------------------
    t0 = time.time()
    result = gan.train(TrainConfig(
        synthetic=shapes, epochs=gan_epochs, seed=seed, batch_size=32, model_dir=model_dir,
        plot_dir=plot_dir, resume=stage_resume("gan_training.csv"), cpu=cpu,
        extras={"save_every": save_every}))
    timings["train_voxel_gan"] = time.time() - t0

    t0 = time.time()
    z = torch.randn((samples, LATENT_CODE_SIZE), generator=torch.Generator().manual_seed(seed + 7))
    with torch.no_grad():
        gen_voxels = result["generator"](z.to(device), train=False)
    voxel_clouds = sample_from_voxels(gen_voxels.cpu().numpy(), point_count=point_count,
                                      seed=seed + 7, device=device)
    voxel_gan = _score(voxel_clouds, gt_clouds, point_count, device)
    timings["score_voxel_gan"] = time.time() - t0
    print(f"voxel GAN: mmd_cd={voxel_gan['mmd_cd']:.5f} cov_cd={voxel_gan['cov_cd']:.3f} "
          f"({voxel_gan['empty_samples']} empty)")

    # --- B. progressive chain 0 -> 1 -> 2 -> 3 ----------------------------
    t0 = time.time()
    for iteration in range(4):
        if iteration > 0:
            for name in (prog.G_NAME, prog.D_NAME):
                if not checkpoints.exists(name.format(iteration - 1), base=model_dir):
                    raise AssertionError(f"iteration {iteration}: missing warm-start checkpoint "
                                         f"{name.format(iteration - 1)}")
        extras = {"save_every": save_every, "g_every": prog_g_every, "learn_rate": prog_lr}
        if prog_d_lr is not None:
            extras["d_learn_rate"] = prog_d_lr
        net = prog.train(TrainConfig(
            synthetic=shapes, epochs=prog_epochs, iteration=iteration, seed=seed, batch_size=16,
            model_dir=model_dir, plot_dir=plot_dir, cpu=cpu, extras=extras,
            resume=stage_resume(f"hybrid_gan_training_{iteration}.csv")))["net"]
        _assert_finite_csv(os.path.join(plot_dir, f"hybrid_gan_training_{iteration}.csv"), iteration)
    timings["train_progressive_chain"] = time.time() - t0

    t0 = time.time()
    codes = torch.randn((samples, LATENT_CODE_SIZE),
                        generator=torch.Generator().manual_seed(seed + 11)).to(device)
    prog_clouds = sample_point_clouds(net, codes, point_count=point_count,
                                      voxel_resolution=mesh_resolution, seed=seed + 11)
    progressive = _score(prog_clouds, gt_clouds, point_count, device)
    timings["score_progressive"] = time.time() - t0
    print(f"progressive 64^3: mmd_cd={progressive['mmd_cd']:.5f} "
          f"cov_cd={progressive['cov_cd']:.3f} ({progressive['empty_samples']} empty)")

    # --- C. sample sheet ------------------------------------------------
    sheet_path = None
    if sheet:
        t0 = time.time()
        sheet_path = os.path.join(plot_dir, "gan_shapes.png")
        render_sample_sheet(torch.as_tensor(gt_voxels[:8], device=device), gen_voxels[:8], net,
                            codes[:8], mesh_resolution, sheet_path)
        timings["sample_sheet"] = time.time() - t0
        print(f"sample sheet: {sheet_path}")

    # --- D. gate and record ---------------------------------------------
    thresholds = dict(DEFAULT_GATES)
    thresholds.update(gates or {})
    checks = (
        ("voxel_gan.mmd_cd", voxel_gan["mmd_cd"], "<=", thresholds["voxel_mmd_max"]),
        ("voxel_gan.cov_cd", voxel_gan["cov_cd"], ">=", thresholds["voxel_cov_min"]),
        ("progressive.mmd_cd", progressive["mmd_cd"], "<=", thresholds["prog_mmd_max"]),
        ("progressive.cov_cd", progressive["cov_cd"], ">=", thresholds["prog_cov_min"]),
    )
    failures = []
    print("\n=== GAN quality gate ===")
    for name, value, op, bound in checks:
        ok = value <= bound if op == "<=" else value >= bound
        print(f"{name}: {value:.5f} ({op} {bound:g}) {'PASS' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    for k, v in timings.items():
        print(f"{k}: {v:.1f}s")

    record = {
        "gate": "gan",
        "voxel_gan": voxel_gan,
        "progressive": progressive,
        "thresholds": thresholds,
        "config": {"shapes": shapes, "samples": samples, "gan_epochs": gan_epochs,
                   "prog_epochs": prog_epochs, "point_count": point_count,
                   "gt_count": gt_count, "seed": seed,
                   "prog_g_every": prog_g_every, "prog_lr": prog_lr,
                   "prog_d_lr": prog_d_lr},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "sample_sheet": sheet_path,
        "pass": not failures,
        "failures": failures,
    }
    with open(os.path.join(workdir, "gate_gan.json"), "w") as f:
        json.dump(record, f, indent=1)
    print("GATE " + json.dumps(record), flush=True)
    return record


def _score(clouds: np.ndarray, reference: np.ndarray, point_count: int, device) -> dict:
    """MMD-CD and COV-CD of generated clouds against the reference, empty
    ones punished, and the number of empty ones."""
    empty = int(np.sum(~clouds.any(axis=(1, 2))))
    clouds = _punish_empty(clouds, point_count)
    return {"mmd_cd": minimum_matching_distance(clouds, reference, device),
            "cov_cd": coverage(clouds, reference, device),
            "empty_samples": empty}


def _punish_empty(clouds: np.ndarray, point_count: int) -> np.ndarray:
    """Replace all-zero (empty-mesh) clouds with a far-away dummy so MMD/COV
    punish them instead of treating the origin blob as a shape."""
    clouds = clouds.copy()
    empty = ~clouds.any(axis=(1, 2))
    clouds[empty] = np.full((point_count, 3), 10.0, np.float32)
    return clouds


def _assert_finite_csv(path: str, iteration: int) -> None:
    """Every logged epoch line of the chain must be finite (CSV columns:
    epoch time pred_fake pred_real gradient_penalty); raises AssertionError
    otherwise."""
    values = np.loadtxt(path, ndmin=2)
    if values.shape[0] == 0:
        raise AssertionError(f"iteration {iteration}: empty training log {path}")
    if not np.all(np.isfinite(values)):
        raise AssertionError(f"iteration {iteration}: non-finite training telemetry in {path}")


def render_sample_sheet(data_voxels, gan_voxels, net, codes, mesh_resolution: int, path: str,
                        tile: int = 128) -> None:
    """A three-row PNG (dataset volumes, voxel-GAN volumes, meshes of the SDF
    generator ``net`` at ``codes``) of ``tile``-pixel renders from the
    headless viewer, cropped and area-resized; a code with an empty mesh
    gets a white tile."""
    viewer = MeshRenderer(size=2 * tile, start_thread=False)
    rows = []
    for color, volumes in (((0.25, 0.45, 0.8), data_voxels), ((0.8, 0.1, 0.1), gan_voxels)):
        viewer.model_color = color
        row = []
        for volume in volumes:
            viewer.set_voxels(volume)
            row.append(viewer.get_image(crop=True, output_size=tile))
        rows.append(row)
    viewer.model_color = (0.85, 0.55, 0.1)
    row = []
    for code in codes:
        mesh = net.get_mesh(code, voxel_resolution=mesh_resolution)
        if mesh is None:
            row.append(np.full((tile, tile, 3), 255, np.uint8))
            continue
        viewer.set_mesh(mesh)
        row.append(viewer.get_image(crop=True, output_size=tile))
    rows.append(row)

    pad = 4
    width = max(len(r) for r in rows)
    grid = np.full((len(rows) * (tile + pad) + pad, width * (tile + pad) + pad, 3), 255, np.uint8)
    for y, row in enumerate(rows):
        for x, image in enumerate(row):
            oy, ox = pad + y * (tile + pad), pad + x * (tile + pad)
            grid[oy:oy + tile, ox:ox + tile] = image
    write_png(path, grid)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (shapegan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  1. the card: name, and name + power limit from nvidia-smi;
  2. build the CUDA kernels from ops/csrc/ (nvcc, sm_90a) and print the time
     and the compiler's register/spill report;
  3. each kernel against its plain PyTorch version on the card, with the
     bundled trained weights at full width (8x256, L=128), at the main
     path's shapes and at an odd shape with a padded tail;
  4. median times of kernel and plain version at the main path's shapes;
  5. the generation path, with every launch count set to 0 first: slice A,
     generate_volumes_inference on 16 codes at 64^3 (the grid kernel), and
     slice B, the demo_sdf_net entry point in mesh mode at 128^3 (the points
     kernel) in a temporary directory; outputs checked, and the counts must
     show both kernels ran;
  6. the training path: the progressive WGAN-GP trainer's entry point for
     iterations 0 -> 3 in turn (synthetic=32, epochs=1, batch 16, nogui) in
     a temporary directory, each iteration with the launch counts set to 0
     just before it; its losses, checkpoints and CSV checked, and the counts
     must show the grid kernel and the grid backward kernel ran in every
     iteration;
  7. the trainer's G-step and D-step times at each resolution (host clock
     after a synchronize, median of 5).
The last lines are a JSON object of the kernels, the card's name and power
limit, and {"ok": true, "device": {...}}. Without CUDA, or without the repo
beside it, the script exits non-zero before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain version on identical bf16 operands. Both round to bf16 at
# the same points, so only the head's float32 summation order differs:
# measured max 1.1e-8, mean 1.4e-9 on the H100. A kernel with one rounding
# point wrong (no bf16 round before the bias add, layer-5 adds in float32,
# an fp16 or float32 trunk) reads max >= 1.4e-4, mean >= 2.3e-5 (PERF.md,
# section 6); the bounds sit between the two.
KERNEL_MAX_ABS = 1e-5
KERNEL_MEAN_ABS = 1e-6
# The grid backward kernel (B2) vs its plain version: relative errors per
# output, ||d||_2 / ||ref||_2 for all eight, max|d| / max|ref| for the six
# summed over many rows (not the per-point d_pp1 / d_pp5). Each dz is
# rounded to bf16 and feeds the next layer, so float32 sums in another order
# flip a few roundings and the flips spread: measured L2 <= 4.1e-3 and max
# <= 1.1e-2 on the H100 at both shapes (PERF.md, section 6); on the CPU the
# plain version alone, float32 against float64 products, reads L2 <= 3.4e-3.
BWD_L2 = 1e-2
BWD_MAX = 5e-2
BWD_NAMES = ("d_pp1", "d_pp5", "d_zz1", "d_zz5", "d_w", "d_b", "d_w8", "d_b8")
# bf16 path vs the float32 reference math on the bundled trained network:
# measured <= 2.5e-4 at 64^3 and 128^3 (bf16's relative step is 2^-8).
BF16_VS_F32_MAX_ABS = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device time of fn() over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got, want) -> float:
    """Max-abs error of a kernel against its plain version; fails beyond
    the stated tolerances."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"finite={bool(torch.isfinite(got).all())}")
    diff = (got - want).abs()
    max_abs, mean_abs = float(diff.max()), float(diff.mean())
    log(f"  {name}: max_abs={max_abs:.3e} (<= {KERNEL_MAX_ABS}) "
        f"mean_abs={mean_abs:.3e} (<= {KERNEL_MEAN_ABS})")
    if not (max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def compare_backward(name: str, got, want) -> float:
    """B2 against its plain version by the relative bounds above; returns
    the largest absolute error over the outputs."""
    import torch

    torch.cuda.synchronize()
    worst_abs = 0.0
    readings = []
    for out, a, b in zip(BWD_NAMES, got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name} {out}: shape {tuple(a.shape)} vs {tuple(b.shape)}, "
                                 f"finite={bool(torch.isfinite(a).all())}")
        d = (a.double() - b.double()).abs()
        l2 = float(d.norm() / b.double().norm())
        mx = float(d.max() / b.double().abs().max())
        worst_abs = max(worst_abs, float(d.max()))
        readings.append(f"{out} {l2:.2e}/{mx:.2e}")
        if l2 > BWD_L2 or (out not in ("d_pp1", "d_pp5") and mx > BWD_MAX):
            raise AssertionError(f"{name} {out}: L2 {l2:.3e} (<= {BWD_L2}), "
                                 f"max {mx:.3e} (<= {BWD_MAX}): kernel disagrees with plain")
    log(f"  {name}: L2/max relative {', '.join(readings)}; max_abs={worst_abs:.3e}")
    return worst_abs


def train_chain() -> list:
    """Phase 6: the trainer's entry point for iterations 0 -> 3 in a
    temporary directory; returns the launches per iteration."""
    import csv
    import math

    import torch
    from shapegan_tpu_torch.core.config import parse_cli
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.train import hybrid_progressive_gan as T

    launches = []
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for iteration in range(4):
                K.grid_forward_cuda.launch_count = 0
                K.grid_backward_cuda.launch_count = 0
                t0 = time.perf_counter()
                result = T.train(parse_cli([f"iteration={iteration}", "epochs=1", "synthetic=32",
                                            "batch_size=16", "nogui"]))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = {"grid": K.grid_forward_cuda.launch_count,
                          "grid_bwd": K.grid_backward_cuda.launch_count}
                launches.append(counts)
                with open(f"plots/hybrid_gan_training_{iteration}.csv") as f:
                    rows = [r for r in csv.reader(f, delimiter=" ")]
                files = [T.G_NAME.format(iteration), T.D_NAME.format(iteration),
                         T.OPT_NAME.format(iteration)]
                missing = [n for n in files if not os.path.exists(os.path.join("models", n + ".npz"))]
                log(f"  iteration {iteration}: {seconds:.2f} s (first call, host clock), "
                    f"launches {counts}, CSV {rows}, G steps {len(result['g_step_s'])}, "
                    f"D steps {len(result['d_step_s'])}")
                if len(rows) != 1 or len(rows[0]) != 5:
                    raise AssertionError(f"iteration {iteration}: CSV rows {rows}")
                epoch, _, fake, real, gp = (float(v) for v in rows[0])
                if epoch != 0 or not all(math.isfinite(v) for v in (fake, real, gp)) or gp < 0:
                    raise AssertionError(f"iteration {iteration}: bad losses {rows[0]}")
                if missing:
                    raise AssertionError(f"iteration {iteration}: checkpoints missing {missing}")
                if counts["grid"] < 1 or counts["grid_bwd"] < 1:
                    raise AssertionError(f"iteration {iteration}: a kernel never launched {counts}")
                net = result["net"]
                if net.device.type != "cuda":
                    raise AssertionError(f"the generator lies on {net.device}")
        finally:
            os.chdir(cwd)
    return launches


def step_times() -> dict:
    """Phase 7: G-step and D-step medians (ms) at each resolution, on fresh
    random weights and batches."""
    import torch
    from shapegan_tpu_torch import LATENT_CODE_SIZE
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import hybrid_progressive_gan as T

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    times = {}
    for iteration, res in enumerate(T.RESOLUTIONS):
        net, disc = T.create_models(0, device)
        g_step, d_step = T.make_steps(net, disc, RMSprop(net.param_dict(), 1e-4),
                                      RMSprop(dict(disc.named_parameters()), 1e-4), iteration)
        batch = torch.rand((16, res, res, res), generator=gen, device=device) * 0.2 - 0.1

        def run(step):
            z = torch.randn((16, LATENT_CODE_SIZE), generator=gen, device=device)
            alpha = torch.rand((16, 1, 1, 1), generator=gen, device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == "g":
                g_step(z, 1.0)
            else:
                d_step(batch, z, alpha, 1.0)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1000

        for step in ("g", "d"):
            for _ in range(2):
                run(step)
            times[(res, step)] = statistics.median(run(step) for _ in range(5))
        log(f"  {res}^3: G step {times[(res, 'g')]:.3f} ms, D step {times[(res, 'd')]:.3f} ms "
            f"(batch 16, median of 5)")
        del net, disc, batch
        torch.cuda.empty_cache()
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from shapegan_tpu_torch import checkpoints, demo_sdf_net
    from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.ops import _build, sdf_mlp
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.ops.coords import unit_sphere_mask, voxel_coordinates
    from shapegan_tpu_torch.train.hybrid_gan import generate_volumes_inference

    # Plain float32 matmuls stay full float32 (no TF32) in the references;
    # the trainer (phases 6-7) runs with PyTorch's defaults, as a user's run.
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"== 1. card: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    log("== 2. build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"  built {os.path.relpath(lib_path, REPO)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    params = checkpoints.load("sdf_net", base=os.path.join(REPO, "shapegan_tpu", "examples"),
                              device=device)
    codes = checkpoints.load_array(LATENT_CODES_FILENAME,
                                   base=os.path.join(REPO, "shapegan_tpu", "examples"))
    path16 = demo_sdf_net.catmull_rom(codes, 2)[:16].astype("float32")  # 16 codes
    latents16 = torch.tensor(path16, device=device)
    grid64 = voxel_coordinates(64, device=device)
    grid128 = voxel_coordinates(128, device=device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    odd_pts = (torch.rand(3001, 3, generator=gen) * 2.2 - 1.1).to(device)

    log(f"== 3. kernels vs plain versions ({kind})")
    grid_ops = K.grid_operands(params, grid64, latents16)
    grid_err = compare("grid B=16 P=64^3",
                       K.grid_forward_cuda(*grid_ops), K.grid_forward_plain(*grid_ops))
    odd_ops = K.grid_operands(params, odd_pts, latents16[:3])
    grid_err = max(grid_err, compare("grid B=3 P=3001",
                                     K.grid_forward_cuda(*odd_ops), K.grid_forward_plain(*odd_ops)))
    folded = sdf_mlp.fold_latent(params, latents16[0])
    points_ops = K.points_operands(folded, grid128, latents16[0, :0])
    points_err = compare("points N=128^3 L=0",
                         K.points_forward_cuda(*points_ops), K.points_forward_plain(*points_ops))
    odd_points_ops = K.points_operands(params, odd_pts, latents16[1])
    points_err = max(points_err, compare(
        "points N=3001 L=128",
        K.points_forward_cuda(*odd_points_ops), K.points_forward_plain(*odd_points_ops)))
    # B2 with the trained weights at the G step's flagship shape, and with
    # random weights at an odd shape; random cotangents.
    g16 = torch.randn((16, 64**3), generator=gen).to(device)
    bwd_err = compare_backward("grid_bwd B=16 P=64^3", K.grid_backward_cuda(*grid_ops, g16),
                               K.grid_backward_plain(*grid_ops, g16))
    rand_params = sdf_mlp.init(torch.Generator().manual_seed(1), device=device)
    odd_bwd_ops = K.grid_operands(rand_params, odd_pts, torch.randn((3, 128), generator=gen).to(device))
    g3 = torch.randn((3, 3001), generator=gen).to(device)
    bwd_err = max(bwd_err, compare_backward("grid_bwd B=3 P=3001",
                                            K.grid_backward_cuda(*odd_bwd_ops, g3),
                                            K.grid_backward_plain(*odd_bwd_ops, g3)))

    log(f"== 4. times at the main path's shapes ({kind}; {smi})")
    trunk_flop = 2 * 6 * 256 * 256
    times = {}
    for name, kernel, plain, ops, n_points in (
        ("grid", K.grid_forward_cuda, K.grid_forward_plain, grid_ops, 16 * 64**3),
        ("points", K.points_forward_cuda, K.points_forward_plain, points_ops, 128**3),
    ):
        plain_ms = time_ms(lambda: plain(*ops), iters=5)
        kernel_ms = time_ms(lambda: kernel(*ops), iters=10)
        times[name] = (kernel_ms, plain_ms)
        log(f"  {name}: kernel {kernel_ms:.3f} ms ({n_points / kernel_ms / 1e6:.3f} G pts/s, "
            f"{n_points * trunk_flop / kernel_ms / 1e9:.1f} trunk TFLOP/s) | "
            f"plain {plain_ms:.3f} ms ({n_points / plain_ms / 1e6:.3f} G pts/s) | "
            f"n={n_points}")
    # B2: 18 products of 256 x 256 per row (6 rebuild, 6 dh, 6 dW).
    plain_ms = time_ms(lambda: K.grid_backward_plain(*grid_ops, g16), iters=3, warmup=1)
    kernel_ms = time_ms(lambda: K.grid_backward_cuda(*grid_ops, g16), iters=5)
    times["grid_bwd"] = (kernel_ms, plain_ms)
    n_points = 16 * 64**3
    log(f"  grid_bwd: kernel {kernel_ms:.3f} ms ({n_points * 3 * trunk_flop / kernel_ms / 1e9:.1f} "
        f"TFLOP/s over the 18 products) | plain {plain_ms:.3f} ms | n={n_points}")
    del grid_ops, odd_ops, points_ops, odd_points_ops, odd_bwd_ops, g16, g3
    torch.cuda.empty_cache()

    log("== 5. generation path")
    K.grid_forward_cuda.launch_count = 0
    K.points_forward_cuda.launch_count = 0
    net = SDFNet(params)
    if net.device.type != "cuda":
        raise AssertionError(f"the network lies on {net.device}, not on the card")
    t0 = time.perf_counter()
    volumes = generate_volumes_inference(net, grid64, latents16, 64)
    torch.cuda.synchronize()
    log(f"  slice A: generate_volumes_inference 16 x 64^3 in {time.perf_counter() - t0:.3f} s "
        f"(first call, host clock)")
    grid_launches_a = K.grid_forward_cuda.launch_count
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            triangle_counts = demo_sdf_net.main(
                ["mode=mesh", "samples=3", "frames_per_transition=1", "resolution=256",
                 "voxel_resolution=128"])
            torch.cuda.synchronize()
            demo_s = time.perf_counter() - t0
            frames = sorted(os.listdir(demo_sdf_net.OUT_DIR))
            pngs_ok = all(open(os.path.join(demo_sdf_net.OUT_DIR, f), "rb").read(8)
                          == b"\x89PNG\r\n\x1a\n" for f in frames)
        finally:
            os.chdir(cwd)
    launches = {"grid": K.grid_forward_cuda.launch_count,
                "points": K.points_forward_cuda.launch_count}
    log(f"  slice B: demo_sdf_net mesh mode, 3 frames at 128^3 / 256^2 in {demo_s:.2f} s: "
        f"triangles {triangle_counts}, frames {frames}")
    log(f"  launches in the main path: {launches} (grid in slice A: {grid_launches_a})")

    # Slice A's output: finite SDF volumes in [-1, 1] with surfaces, close to
    # the float32 reference math for two of the shapes.
    if volumes.shape != (16, 64, 64, 64) or not torch.isfinite(volumes).all():
        raise AssertionError(f"slice A: bad volumes {tuple(volumes.shape)}")
    if volumes.abs().max() > 1 or not (volumes < 0).flatten(1).any(1).any():
        raise AssertionError("slice A: values outside [-1, 1] or no shape with negative cells")
    ref = sdf_mlp.apply_grid(params, grid64, latents16[:2]).reshape(2, 64, 64, 64)
    a_err = float((volumes[:2] - ref).abs().max())
    log(f"  slice A vs float32 reference (2 shapes): max_abs={a_err:.3e} "
        f"(<= {BF16_VS_F32_MAX_ABS}); shapes with negative cells: "
        f"{int((volumes < 0).flatten(1).any(1).sum())}/16")
    if a_err > BF16_VS_F32_MAX_ABS:
        raise AssertionError("slice A disagrees with the float32 reference")
    # Slice B's output: PNGs of non-empty meshes; one 128^3 volume of the
    # path against the float32 reference.
    if len(frames) != 3 or not pngs_ok or len(triangle_counts) != 3 or min(triangle_counts) <= 0:
        raise AssertionError(f"slice B: frames {frames}, triangles {triangle_counts}")
    code = torch.tensor(codes[0], device=device)
    vox = net.get_voxels(code, 128)
    ref = sdf_mlp.apply_grid(sdf_mlp.fold_latent(params, code), grid128, code[:0][None])
    ref = torch.where(unit_sphere_mask(128, device=device), ref.reshape(128, 128, 128), 1.0)
    b_err = float((vox - ref).abs().max())
    log(f"  slice B volume vs float32 reference at 128^3: max_abs={b_err:.3e} "
        f"(<= {BF16_VS_F32_MAX_ABS})")
    if b_err > BF16_VS_F32_MAX_ABS:
        raise AssertionError("slice B volume disagrees with the float32 reference")
    if grid_launches_a < 1 or launches["points"] < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    log(f"== 6. training path: progressive WGAN-GP, iterations 0 -> 3 ({kind}; TF32: matmul "
        f"{tf32_defaults[0]}, cuDNN {tf32_defaults[1]})")
    chain = train_chain()
    log(f"== 7. trainer step times ({kind}; {smi})")
    step_times()
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    launches["grid"] += sum(c["grid"] for c in chain)
    launches["grid_bwd"] = sum(c["grid_bwd"] for c in chain)

    kernels = [
        {"name": "sdf_grid", "route": "cuda", "source": "shapegan_tpu_torch/ops/csrc/sdf_grid.cu",
         "replaces": "shapegan_tpu/ops/sdf_mlp_pallas.py:50", "launches": launches["grid"],
         "max_abs_err": grid_err, "ms": times["grid"][0], "plain_ms": times["grid"][1]},
        {"name": "sdf_points", "route": "cuda",
         "source": "shapegan_tpu_torch/ops/csrc/sdf_points.cu",
         "replaces": "shapegan_tpu/ops/sdf_mlp_pallas.py:199", "launches": launches["points"],
         "max_abs_err": points_err, "ms": times["points"][0], "plain_ms": times["points"][1]},
        {"name": "sdf_grid_bwd", "route": "cuda",
         "source": "shapegan_tpu_torch/ops/csrc/sdf_grid_bwd.cu",
         "replaces": "shapegan_tpu/ops/sdf_mlp_pallas.py:469", "launches": launches["grid_bwd"],
         "max_abs_err": bwd_err, "ms": times["grid_bwd"][0], "plain_ms": times["grid_bwd"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

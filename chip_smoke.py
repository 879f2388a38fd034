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
  5. the main path, with every launch count set to 0 first: slice A,
     generate_volumes_inference on 16 codes at 64^3 (the grid kernel), and
     slice B, the demo_sdf_net entry point in mesh mode at 128^3 (the points
     kernel) in a temporary directory; outputs checked, and the counts must
     show both kernels ran.
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

    # Plain float32 matmuls stay full float32 (no TF32) in the references.
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
    del grid_ops, odd_ops, points_ops, odd_points_ops
    torch.cuda.empty_cache()

    log("== 5. main path")
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
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    kernels = [
        {"name": "sdf_grid", "route": "cuda", "source": "shapegan_tpu_torch/ops/csrc/sdf_grid.cu",
         "replaces": "shapegan_tpu/ops/sdf_mlp_pallas.py:50", "launches": launches["grid"],
         "max_abs_err": grid_err, "ms": times["grid"][0], "plain_ms": times["grid"][1]},
        {"name": "sdf_points", "route": "cuda",
         "source": "shapegan_tpu_torch/ops/csrc/sdf_points.cu",
         "replaces": "shapegan_tpu/ops/sdf_mlp_pallas.py:199", "launches": launches["points"],
         "max_abs_err": points_err, "ms": times["points"][0], "plain_ms": times["points"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

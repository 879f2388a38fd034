#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (shapegan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  1. the card: name, and name + power limit from nvidia-smi;
  2. build the CUDA kernels from ops/csrc/ (nvcc, sm_90a) and print the time
     and the compiler's register/spill report;
  3. each kernel against its plain PyTorch version on the card, with the
     bundled weights at full width (8x256, L=128), at the main path's
     shapes and at an odd shape with a padded tail; the trace kernel with a
     chair network fitted on the card (shapegan_tpu_torch.examples), on
     primary rays at 1600^2, shadow rays with per-lane escape heights, and
     an odd N with pre-resolved lanes;
  4. median times of kernel and plain version at the main path's shapes,
     and of 20 per-iteration points-kernel trace steps beside the trace
     kernel's 20;
  5. the generation path: slice A, generate_volumes_inference on 16 codes
     at 64^3, whose counts must show the grid kernel ran, and slice B, the
     demo_sdf_net entry point in mesh mode at 128^3 in a temporary
     directory, whose counts must show the points kernel ran; outputs
     checked;
  6. the raymarch path: the fitted chair and a one-row code table saved
     into a temporary models/, the demo_sdf_net entry point in raymarch mode
     (2 frames at 800^2, ssaa 2), then render_image (4 frames, the median of
     the last 3 timed) with the fused trace switch off, then on. In each of
     the three runs the grid and grid backward kernels (the normals) must
     have launched; with the switch on the trace kernel must have launched
     and the points kernel not (every bucket at 800^2 holds >= 2048 lanes),
     with it off the reverse. PNGs, the frame's coverage, the two switch
     settings' agreement and the hit points' distance to the analytic chair
     checked;
  7. the training path: the progressive WGAN-GP trainer's entry point for
     iterations 0 -> 3 in turn (synthetic=32, epochs=1, batch 16, nogui) in
     a temporary directory; its losses, checkpoints and CSV checked, and the
     counts must show the grid kernel and the grid backward kernel ran in
     every iteration;
  8. the trainer's G-step and D-step times at each resolution (host clock
     after a synchronize, median of 5).
Each run of a path in phases 5-7 starts with every launch count set to 0
and reads the counts just after; launches made to compare a kernel with its
plain version or to time it are never counted. The kernels line gives each
kernel's launches summed over those runs, and per run.
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
# bf16 path vs the float32 reference math on the bundled network (not a
# trained shape: about -0.02 everywhere, PERF.md section 6): measured
# <= 2.5e-4 at 64^3 and 128^3 (bf16's relative step is 2^-8).
BF16_VS_F32_MAX_ABS = 1e-3
# The trace kernel (B4) vs its plain version on the same operands. The SDF of
# a lane differs by float32 rounding (the head's summation order, tanhf), so
# a lane's float32 point can differ by an ulp, and rarely that flips the
# point's bf16 rounding, which moves the lane's later SDF by ~1e-3 and can
# flip its status. Bounds: the share of lanes whose status agrees, the
# largest |dp| over lanes whose status agrees, and the share of those with
# |dp| > 1e-6. Measured on the H100 (all three cases): agreement 1.0, max
# |dp| 1.9e-3, share 3.6e-5. Three wrong kernels each fail these bounds in
# a run with them (PERF.md, section 6): the miss test before the hit test
# (agreement 0.989 on the odd case), no bf16 rounding of the trunk input
# (agreement 0.983, max |dp| 0.47), an FMA advance (max |dp| 1.3e-2, share
# 4.6e-3 on the primary rays, share 6.9e-3 on the shadow rays).
TRACE_AGREE = 0.999
TRACE_MAX_DP = 0.01
TRACE_MOVED_SHARE = 1e-3
# The raymarch frame: its share of non-background pixels (the chair plus
# its ground shadow), the share of pixels on which the two switch settings'
# frames differ, and the hit points' distance to the analytic chair.
FRAME_COVERAGE = (0.05, 0.6)
SWITCH_PIXELS_DIFFER = 0.01
HIT_SURFACE_DIST = 0.02
HIT_SURFACE_SHARE = 0.95
# Sizes: the trace kernel's rays (the frame's 800^2 x ssaa 2), the demo's
# frames, and the hit-point check.
TRACE_SIZE = 1600
FRAME_RESOLUTION = 800
HIT_CHECK_SIZE = 400


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def launch_counters() -> dict:
    """Each kernel's wrapper under the name the paths report it by; a
    wrapper adds one to its ``launch_count`` where it launches its kernel."""
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    return {"grid": K.grid_forward_cuda, "grid_bwd": K.grid_backward_cuda,
            "points": K.points_forward_cuda, "trace": K.trace_steps_cuda}


def reset_counts() -> None:
    for fn in launch_counters().values():
        fn.launch_count = 0


def read_counts() -> dict:
    return {name: fn.launch_count for name, fn in launch_counters().items()}


def check_counts(path: str, counts: dict, launched=(), idle=()) -> None:
    """Fails unless every kernel in ``launched`` ran at least once in the
    path's run and none in ``idle`` ran."""
    log(f"  launches in {path}: {counts}")
    wrong = [k for k in launched if counts[k] < 1] + [k for k in idle if counts[k] != 0]
    if wrong:
        raise AssertionError(f"{path}: launches {counts}; expected >= 1 of {list(launched)} "
                             f"and none of {list(idle)}")


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


def trace_cases(chair, device) -> list:
    """B4's operands at the main path's shapes: (name, pts, dirs, status,
    escape, keywords)."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.render import raymarching as rm

    cam = torch.tensor(rm.CAMERA_POSITION, dtype=torch.float32, device=device)
    pts, dirs, entered = rm.camera_rays(cam, TRACE_SIZE)
    status = torch.where(entered, K.TRACE_ACTIVE, K.TRACE_MISS).to(torch.int32)
    primary_kw = dict(k=20, shadow=False, threshold=0.0005, step_clamp=0.02, sdf_offset=0.0,
                      radius=1.0)
    weights = K.point_weights(chair, dirs[0, :0])
    # Shadow rays from where the primary rays are after 20 plain steps,
    # toward the light; escape heights 1.0 and 1.6 on alternate lanes.
    start, _ = K.trace_steps_plain(pts, dirs, status, None, *weights, **primary_kw)
    light = torch.tensor(rm.LIGHT_POSITION, dtype=torch.float32, device=device)
    to_light = light[None, :] - start
    to_light = to_light / torch.linalg.norm(to_light, dim=1, keepdim=True)
    escape = torch.where(torch.arange(pts.shape[0], device=device) % 2 == 0, 1.0, 1.6)
    # An odd N with pre-resolved lanes (every 10th HIT, every 10th MISS):
    # radius 0.5 and threshold = step clamp put many lanes both outside and
    # in the hit window at once, where a hit must win.
    gen = torch.Generator().manual_seed(3)
    odd = torch.randn((3001, 3), generator=gen)
    odd_dirs = torch.randn((3001, 3), generator=gen)
    odd = odd / torch.linalg.norm(odd, dim=1, keepdim=True) * torch.rand((3001, 1), generator=gen) ** (1 / 3)
    odd_dirs = odd_dirs / torch.linalg.norm(odd_dirs, dim=1, keepdim=True)
    lane = torch.arange(3001)
    odd_status = torch.where(lane % 10 == 3, K.TRACE_HIT,
                             torch.where(lane % 10 == 7, K.TRACE_MISS, K.TRACE_ACTIVE)).to(torch.int32)
    return [
        (f"primary {TRACE_SIZE}^2 k=20", pts, dirs, status, None, primary_kw),
        (f"shadow {TRACE_SIZE}^2 k=20 escape 1.0/1.6", start + to_light * 0.1, to_light, status,
         escape.float(), dict(primary_kw, shadow=True, threshold=0.001, step_clamp=0.1)),
        ("odd N=3001 k=20 pre-resolved", odd.to(device), odd_dirs.to(device),
         odd_status.to(device), None,
         dict(k=20, shadow=False, threshold=0.02, step_clamp=0.02, sdf_offset=0.0, radius=0.5)),
    ]


def compare_trace(name: str, got, want, start) -> float:
    """B4 against its plain version by the bounds above; pre-resolved lanes
    must keep their points and status exactly. Returns max |dp| over the
    lanes whose status agrees."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    torch.cuda.synchronize()
    (g_pts, g_st), (w_pts, w_st) = got, want
    if g_pts.shape != w_pts.shape or g_st.shape != w_st.shape or not torch.isfinite(g_pts).all():
        raise AssertionError(f"{name}: shapes {tuple(g_pts.shape)} {tuple(g_st.shape)}, "
                             f"finite={bool(torch.isfinite(g_pts).all())}")
    same = g_st == w_st
    agree = float(same.float().mean())
    dp = (g_pts - w_pts).abs().amax(1)[same]
    max_dp = float(dp.max())
    moved = float((dp > 1e-6).float().mean())
    differ = float((dp > 0).float().mean())
    resolved = start[1] != K.TRACE_ACTIVE
    frozen = bool((g_pts[resolved] == start[0][resolved]).all()
                  and (g_st[resolved] == start[1][resolved]).all())
    counts = [int((g_st == c).sum()) for c in (K.TRACE_ACTIVE, K.TRACE_HIT, K.TRACE_MISS)]
    log(f"  trace {name}: status agree {agree:.6f} (>= {TRACE_AGREE}), max|dp| on agreeing "
        f"lanes {max_dp:.3e} (<= {TRACE_MAX_DP}), share with |dp| > 1e-6 {moved:.2e} "
        f"(<= {TRACE_MOVED_SHARE}), "
        f"with dp != 0 {differ:.2e}; "
        f"pre-resolved lanes unchanged: {frozen}; active/hit/miss {counts}")
    if agree < TRACE_AGREE or max_dp > TRACE_MAX_DP or moved > TRACE_MOVED_SHARE or not frozen:
        raise AssertionError(f"trace {name}: kernel disagrees with its plain version")
    return max_dp


def check_raymarch_counts(path: str, counts: dict, fused: bool) -> None:
    """The normals launch the grid kernel and its backward; the traces
    launch the trace kernel with the fused switch on (every bucket of an
    800^2 x ssaa 2 frame holds >= FUSED_MIN_LANES lanes, so no points-kernel
    step runs) and the points kernel with it off."""
    traced, idle = ("trace", "points") if fused else ("points", "trace")
    check_counts(path, counts, launched=("grid", "grid_bwd", traced), idle=(idle,))


def raymarch_path(chair, code, kind: str) -> dict:
    """Phase 6: the demo in raymarch mode on the fitted chair in a temporary
    directory, then render_image timed with the fused trace switch off and
    on, each run with its own launch counts; returns the counts per run and
    the readings."""
    import numpy as np
    import torch
    from shapegan_tpu_torch import checkpoints, demo_sdf_net
    from shapegan_tpu_torch.examples import CHAIR_SCALE, example_chair_sdf
    from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.render import raymarching as rm
    from shapegan_tpu_torch.render.png import read_png

    paths = {}
    default = rm._FORCE_FUSED_TRACE
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            checkpoints.save(chair, "sdf_net", base="models")
            checkpoints.save_array(code[None].cpu().numpy(), LATENT_CODES_FILENAME, base="models")
            reset_counts()
            t0 = time.perf_counter()
            coverage_px = demo_sdf_net.main(["mode=raymarch", "samples=1",
                                             "frames_per_transition=2",
                                             f"resolution={FRAME_RESOLUTION}"])
            torch.cuda.synchronize()
            demo_s = time.perf_counter() - t0
            paths["raymarch demo"] = read_counts()
            frames = [read_png(os.path.join(demo_sdf_net.OUT_DIR, f))
                      for f in sorted(os.listdir(demo_sdf_net.OUT_DIR))]
        finally:
            os.chdir(cwd)
    log(f"  demo_sdf_net raymarch mode, 2 frames at {FRAME_RESOLUTION}^2 (ssaa 2, fused switch {default}) in "
        f"{demo_s:.2f} s (first call, host clock); non-background pixels {coverage_px}")
    check_raymarch_counts("raymarch demo", paths["raymarch demo"], default)

    net = SDFNet(chair)
    images, frame_ms = {}, {}
    try:
        for fused in (False, True):
            rm._FORCE_FUSED_TRACE = fused
            path = f"render_image, fused switch {'on' if fused else 'off'}"
            times = []
            reset_counts()
            for _ in range(4):  # the first is a warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                images[fused] = rm.render_image(net, code, resolution=FRAME_RESOLUTION)
                times.append((time.perf_counter() - t0) * 1e3)
            paths[path] = read_counts()
            frame_ms[fused] = statistics.median(times[1:])
            log(f"  render_image {FRAME_RESOLUTION}^2 ssaa 2, fused trace switch {fused}: "
                f"{frame_ms[fused]:.3f} ms (host clock, median of 3; {kind})")
            check_raymarch_counts(path, paths[path], fused)
    finally:
        rm._FORCE_FUSED_TRACE = default

    # The frames: RGB at the demo's resolution, the chair plus its ground shadow covering a
    # plausible share, and the two switch settings nearly the same frame.
    coverage = [float((f != 255).any(axis=2).mean()) for f in frames]
    differ = float((images[False] != images[True]).any(axis=2).mean())
    log(f"  frames {[f.shape for f in frames]}, non-background share {coverage} "
        f"(in {FRAME_COVERAGE}); pixels differing between switch settings {differ:.2e} "
        f"(<= {SWITCH_PIXELS_DIFFER}); demo frame vs render_image: "
        f"{float((frames[0] != images[default]).any(axis=2).mean()):.2e} of pixels differ")
    if len(frames) != 2 or any(f.shape != (FRAME_RESOLUTION, FRAME_RESOLUTION, 3) for f in frames):
        raise AssertionError(f"raymarch frames: {[f.shape for f in frames]}")
    if not all(FRAME_COVERAGE[0] <= c <= FRAME_COVERAGE[1] for c in coverage):
        raise AssertionError(f"raymarch frames: non-background share {coverage}")
    if differ > SWITCH_PIXELS_DIFFER:
        raise AssertionError(f"the switch settings' frames differ on {differ:.3e} of pixels")
    # The surface the trace finds is the chair's: primary hits lie within
    # HIT_SURFACE_DIST of the analytic (scaled) chair.
    folded = sdf_mlp.fold_latent(chair, code)
    cam = torch.tensor(rm.CAMERA_POSITION, dtype=torch.float32, device=code.device)
    pts, dirs, entered = rm.camera_rays(cam, HIT_CHECK_SIZE)
    status = torch.where(entered, K.TRACE_ACTIVE, K.TRACE_MISS).to(torch.int32)
    schedule = rm._default_schedule("primary", HIT_CHECK_SIZE**2, 1000)
    pts, status = rm._trace_staged("primary", folded, code[:0], pts, dirs, status, 1000, 0.0005,
                                   0.02, 0.0, 1.0, schedule, tail_cap=rm.TAIL_ITERS)
    hits = pts[status != K.TRACE_MISS].cpu().numpy().astype(np.float64)
    dist = np.abs(example_chair_sdf(hits / CHAIR_SCALE) * CHAIR_SCALE)
    near = float((dist < HIT_SURFACE_DIST).mean())
    log(f"  primary hits at {HIT_CHECK_SIZE}^2: {len(hits)}, share within {HIT_SURFACE_DIST} of the analytic "
        f"chair {near:.4f} (>= {HIT_SURFACE_SHARE}), median distance {float(np.median(dist)):.2e}")
    if near < HIT_SURFACE_SHARE or len(hits) < 0.05 * HIT_CHECK_SIZE**2:
        raise AssertionError("the traced surface is not the chair's")
    return {"paths": paths, "frame_ms": frame_ms, "coverage": coverage, "differ": differ}


def train_chain() -> dict:
    """Phase 7: the trainer's entry point for iterations 0 -> 3 in a
    temporary directory; returns the launch counts per iteration."""
    import csv
    import math

    import torch
    from shapegan_tpu_torch.core.config import parse_cli
    from shapegan_tpu_torch.train import hybrid_progressive_gan as T

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for iteration in range(4):
                reset_counts()
                t0 = time.perf_counter()
                result = T.train(parse_cli([f"iteration={iteration}", "epochs=1", "synthetic=32",
                                            "batch_size=16", "nogui"]))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = paths[f"training iteration {iteration}"] = read_counts()
                with open(f"plots/hybrid_gan_training_{iteration}.csv") as f:
                    rows = [r for r in csv.reader(f, delimiter=" ")]
                files = [T.G_NAME.format(iteration), T.D_NAME.format(iteration),
                         T.OPT_NAME.format(iteration)]
                missing = [n for n in files if not os.path.exists(os.path.join("models", n + ".npz"))]
                log(f"  iteration {iteration}: {seconds:.2f} s (first call, host clock), "
                    f"CSV {rows}, G steps {len(result['g_step_s'])}, "
                    f"D steps {len(result['d_step_s'])}")
                if len(rows) != 1 or len(rows[0]) != 5:
                    raise AssertionError(f"iteration {iteration}: CSV rows {rows}")
                epoch, _, fake, real, gp = (float(v) for v in rows[0])
                if epoch != 0 or not all(math.isfinite(v) for v in (fake, real, gp)) or gp < 0:
                    raise AssertionError(f"iteration {iteration}: bad losses {rows[0]}")
                if missing:
                    raise AssertionError(f"iteration {iteration}: checkpoints missing {missing}")
                check_counts(f"training iteration {iteration}", counts,
                             launched=("grid", "grid_bwd"))
                net = result["net"]
                if net.device.type != "cuda":
                    raise AssertionError(f"the generator lies on {net.device}")
        finally:
            os.chdir(cwd)
    return paths


def step_times() -> dict:
    """Phase 8: G-step and D-step medians (ms) at each resolution, on fresh
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
    from shapegan_tpu_torch.examples import fit_chair
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
    # B2 with the bundled weights at the G step's flagship shape, and with
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
    # B4 with a network that has a real surface: the chair, fitted here with
    # the float32 reference math (the bundled network has none).
    t0 = time.perf_counter()
    chair, chair_code = fit_chair(device)
    torch.cuda.synchronize()
    log(f"  fitted the chair (800 Adam steps of 16384 points, float32) in "
        f"{time.perf_counter() - t0:.2f} s")
    chair_folded = sdf_mlp.fold_latent(chair, chair_code)
    chair_weights = K.point_weights(chair_folded, chair_code[:0])
    trace_err = 0.0
    cases = trace_cases(chair_folded, device)
    for name, pts, dirs, status, escape, kw in cases:
        ops = (pts, dirs, status, escape) + chair_weights
        trace_err = max(trace_err, compare_trace(name, K.trace_steps_cuda(*ops, **kw),
                                                 K.trace_steps_plain(*ops, **kw), (pts, status)))

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
    # B4: 20 trace steps over the 1600^2 primary rays, beside 20 steps of
    # one points-kernel launch and the element-wise update each (the A/B of
    # the raymarcher's fused trace switch).
    name, pts, dirs, status, escape, kw = cases[0]
    ops = (pts, dirs, status, escape) + chair_weights
    plain_ms = time_ms(lambda: K.trace_steps_plain(*ops, **kw), iters=3, warmup=1)
    kernel_ms = time_ms(lambda: K.trace_steps_cuda(*ops, **kw), iters=10)

    def points_steps():
        p, st = pts, status
        for _ in range(kw["k"]):
            sdf = K.points_forward_cuda(p, *chair_weights)
            p, st = K.trace_update(p, dirs, st, sdf, escape=escape,
                                   **{k: v for k, v in kw.items() if k != "k"})
        return p, st

    b3_ms = time_ms(points_steps, iters=10)
    times["trace"] = (kernel_ms, plain_ms)
    n_evals = pts.shape[0] * kw["k"]
    log(f"  trace ({name}): kernel {kernel_ms:.3f} ms ({n_evals / kernel_ms / 1e6:.3f} G lane-steps/s) "
        f"| plain {plain_ms:.3f} ms | 20 points-kernel steps {b3_ms:.3f} ms "
        f"({n_evals / b3_ms / 1e6:.3f} G lane-steps/s) | lanes={pts.shape[0]}, "
        f"{int((status == 0).sum())} active at the start")
    del grid_ops, odd_ops, points_ops, odd_points_ops, odd_bwd_ops, g16, g3, cases, ops
    torch.cuda.empty_cache()

    log("== 5. generation path")
    paths = {}
    net = SDFNet(params)
    if net.device.type != "cuda":
        raise AssertionError(f"the network lies on {net.device}, not on the card")
    reset_counts()
    t0 = time.perf_counter()
    volumes = generate_volumes_inference(net, grid64, latents16, 64)
    torch.cuda.synchronize()
    paths["generate_volumes_inference"] = read_counts()
    log(f"  slice A: generate_volumes_inference 16 x 64^3 in {time.perf_counter() - t0:.3f} s "
        f"(first call, host clock)")
    check_counts("generate_volumes_inference", paths["generate_volumes_inference"],
                 launched=("grid",))
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            t0 = time.perf_counter()
            triangle_counts = demo_sdf_net.main(
                ["mode=mesh", "samples=3", "frames_per_transition=1", "resolution=256",
                 "voxel_resolution=128"])
            torch.cuda.synchronize()
            demo_s = time.perf_counter() - t0
            paths["mesh demo"] = read_counts()
            frames = sorted(os.listdir(demo_sdf_net.OUT_DIR))
            pngs_ok = all(open(os.path.join(demo_sdf_net.OUT_DIR, f), "rb").read(8)
                          == b"\x89PNG\r\n\x1a\n" for f in frames)
        finally:
            os.chdir(cwd)
    log(f"  slice B: demo_sdf_net mesh mode, 3 frames at 128^3 / 256^2 in {demo_s:.2f} s: "
        f"triangles {triangle_counts}, frames {frames}")
    check_counts("mesh demo", paths["mesh demo"], launched=("points",))

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

    log(f"== 6. raymarch path ({kind}; {smi})")
    paths.update(raymarch_path(chair, chair_code, f"{kind}; {smi}")["paths"])
    del chair, chair_folded, chair_weights
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    log(f"== 7. training path: progressive WGAN-GP, iterations 0 -> 3 ({kind}; TF32: matmul "
        f"{tf32_defaults[0]}, cuDNN {tf32_defaults[1]})")
    paths.update(train_chain())
    log(f"== 8. trainer step times ({kind}; {smi})")
    step_times()
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    def kernel_entry(name, counter, source, replaces, err):
        return {"name": name, "route": "cuda", "source": f"shapegan_tpu_torch/ops/csrc/{source}",
                "replaces": f"shapegan_tpu/ops/sdf_mlp_pallas.py:{replaces}",
                "launches": sum(p[counter] for p in paths.values()),
                "launches_by_path": {path: p[counter] for path, p in paths.items() if p[counter]},
                "max_abs_err": err, "ms": times[counter][0], "plain_ms": times[counter][1]}

    kernels = [
        kernel_entry("sdf_grid", "grid", "sdf_grid.cu", 50, grid_err),
        kernel_entry("sdf_points", "points", "sdf_points.cu", 199, points_err),
        kernel_entry("sdf_grid_bwd", "grid_bwd", "sdf_grid_bwd.cu", 469, bwd_err),
        kernel_entry("sdf_trace", "trace", "sdf_trace.cu", 331, trace_err),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

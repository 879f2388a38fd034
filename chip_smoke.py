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
     an odd N with pre-resolved lanes; the rowwise kernel and its backward
     at the autodecoder's batch (20,000 rows, codes gathered from a 64-row
     table, the bundled weights) and at N=3001 with random weights, the
     backward B6b also at N = 1, 63, 65 and 129 (tails inside a 64-row tile
     and one-row tails, fewer tiles than consumers) and twice at 20,000 rows,
     the same bytes; the rowwise forward B6a also at N = 1, 63, 65 and 129
     and twice at 20,000 rows, the same bytes; the
     point-GAN generator kernel at the D step's 32 x 4096 points (twice, the
     same bytes), at B=3, N=1000 (a tail tile, tiles spanning two items) and
     at B=2, N=100 (fewer tiles than consumer warpgroups), fresh weights;
     the grid backward's rows pass alone (B2's Hopper rows kernel,
     ``sdf_grid_backward_rows``: its h and dz planes, dx1 and gz against
     ``grid_backward_rows_plain``) at 16 x 64^3 with the bundled weights (one
     shape a call) and at B=3, P=3001 with random weights; the grid
     backward's passes 2-4 alone (``grid_backward_passes_cuda``: the wgmma
     weight kernel and the fan-in of ``sdf_bwd_passes_sm90.cuh``) against
     ``grid_backward_passes_plain`` on the rows pass's planes, at 16 x 64^3
     (16 one-shape chunks) and at B=3, P=3001 (one chunk of three shapes,
     and the last two as a chunk from s0 = 1); two calls of B2 giving the
     same bytes; the stash forward
     kernel (B5a: its output equal to B1's, its planes to the plain
     version's) and the stash backward kernel (B5b) at 16 x 64^3 and B=3,
     P=3001 with random weights, stash sets (2,4,6) and (1..6); B1 and B5a
     (both sets; its output equal to B1's) also at B1's four cases
     (grid_cases: 16 x 64^3 and B=3, P=3001 with the bundled weights, B=1
     and B=5, P=6401 with random weights);
  4. median times of kernel and plain version at the main path's shapes
     (B2's rows pass and its passes 2-4 also alone, each beside its own
     bound and B2's total),
     and of 20 per-iteration points-kernel trace steps beside the trace
     kernel's 20; the rowwise kernels at 20,000 and 65,536 rows, B6b also
     by pass (``torch.profiler`` device time: its rows pass, the weight
     kernel, the finishes, the d_w8 / d_b8 sums, the zeroing), B6a also as
     a call's share of ten back to back; the
     generator kernel at 32 x 4096 and 6 x 32768 beside the bf16 module (the
     fused switch's other side), and as a call's share of ten back to back; B5a and B5b at 16 x 64^3 for both stash
     sets beside B1 and B2 (the kernels line takes the trainers' set,
     ``hybrid_gan._GRID_STASH``, or (1..6) when the trainers ship the
     recompute); each kernel's bound (the larger of its
     operations over the bf16 tensor-core peak and its bytes over the
     memory rate, from this run's shapes; the trace kernel's from the
     lane-steps its rays need), and each kernel's TFLOP/s and share of its
     bound's rate;
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
     counts must show the grid kernel once a D step in every iteration,
     and the G step's VJP that ``hybrid_gan._GRID_STASH`` picks once a G
     step (by default None: the grid kernel and the grid backward kernel,
     and no stash kernel; with a stash set the stash kernels B5a and B5b and
     no grid backward);
  8. the trainer's G-step and D-step times at each resolution (host clock
     after a synchronize, median of 5), the G step through the default VJP;
  9. the autodecoder path: the DeepSDF autodecoder trainer's entry point
     (synthetic=64, pointcloud_size=200000, epochs=2, nogui) in a temporary
     directory, then ``continue`` to epochs=3; each run's counts must show
     the rowwise kernel and its backward launched once per step and no
     other kernel; losses finite and falling, checkpoints, snapshots, the
     optimizer sidecar and the CSV checked; the gradients of one kernel
     step against the float32 reference math; the trainer's step time
     beside the same step with autograd over bf16 torch matmuls;
 10. the point-GAN path: the point-set GAN trainer's entry point (synthetic=64,
     epochs=1: all six curriculum stages, 23 steps) in a temporary
     directory, then ``continue`` to epochs=2 (stages 4-6 twice, 34 steps),
     both with the fused generator switch on, then epochs=1 in another
     directory with it off; with the
     switch on the generator kernel must have launched once per D step and
     no other kernel, with it off none; losses finite, checkpoints, the
     optimizer sidecar and the CSV checked; one D step's fake cloud from the
     kernel against the bf16 module's at the same latents; the D step (switch
     on and off) and G step times at 32 x 4096 and the steps/s they give;
 11. the hybrid GAN and hybrid WGAN paths: each trainer's entry point
     (synthetic=32, batch 8, 32^3, epochs=1, then ``continue`` to epochs=2)
     in temporary directories with the stash switch at its shipped setting
     (``hybrid_gan._GRID_STASH``), then the other way (off, or on with
     (1..6)); on, each G step must launch B5a and B5b and no B2, each D step
     B1; off, each G step B1 and B2; losses, checkpoints, snapshots, sidecars
     and CSV checked; the G-step gradients with the switch off and on
     against float32 truth by the bf16 rule; the A/B behind the switch's
     default: the progressive trainer's G step at 64^3, batch 16, with the
     recompute and the stash sets (2,4,6), (1,2,4,6), (1..6) in turns, with
     each one's peak memory, and the hybrid GAN's G and D steps at 32^3.
Each run of a path in phases 5-7 and 9-11 starts with every launch count set to 0
and reads the counts just after; launches made to compare a kernel with its
plain version or to time it are never counted. The kernels line gives each
kernel's launches summed over the runs made at the shipped switch
settings (the A/B runs with a switch turned the other way are left out
of the sum), and per run.
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
# the same points, so only the float32 summation orders differ (the head's,
# and the wgmma trunk's products in B3): measured max 1.1e-8, mean 1.4e-9 on
# the H100 (B3 on the wgmma trunk: 7.5e-9 / 1.4e-9). A kernel with one
# rounding point wrong (no bf16 round before the bias add, layer-5 adds in
# float32, an fp16 or float32 trunk) reads max >= 1.4e-4, mean >= 2.3e-5,
# and B3 with its K-blocks in the wrong order 4.2e-2 (PERF.md, section 6);
# the bounds sit between the two.
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
# The rowwise backward kernel (B6b) vs its plain version, by the same bounds:
# L2-relative for all six outputs, max-relative for the four summed over
# rows (the per-row dzz1 / dzz5 are exempt from the max bound, as d_pp1 /
# d_pp5 are above). Its rounding points differ from B2's, but the noise is
# the same kind: measured on the H100, L2 <= 7.0e-3 (d_b at 20,000 rows,
# where the plain version with float64 sums reads 5.2e-3 against float32)
# and max <= 1.7e-2 on the summed outputs; three wrong kernels read L2 >=
# 2.2e-2 (PERF.md, section 6).
ROWWISE_BWD_NAMES = ("dzz1", "dzz5", "d_w", "d_b", "d_w8", "d_b8")
ROWWISE_PER_ROW = ("dzz1", "dzz5")
# The autodecoder step's gradients through the kernels against the float32
# reference math (sdf_mlp.apply), by cosine, per parameter and for the
# latent table: the criterion of the JAX package's bf16 step test
# (tests/test_train_autodecoder.py).
AUTODECODER_GRAD_COSINE = 0.98
# The card's published peaks (NVIDIA H100 SXM, dense, 700 W): bf16 tensor
# cores and device memory. A kernel's bound is the larger of its operations
# over the first and its bytes over the second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
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
# |dp| 1.9e-3, share 3.6e-5 (the wgmma kernel: 2.4e-5). Wrong kernels each
# fail these bounds in a run with them (PERF.md, section 6): the miss test
# before the hit test (agreement 0.989 on the odd case), no bf16 rounding of
# the trunk input (agreement 0.983, max |dp| 0.47), an FMA advance (max |dp|
# 1.3e-2, share 4.6e-3 on the primary rays, share 6.9e-3 on the shadow
# rays), a refilled slot that keeps the last lane's step count (agreement
# 0.955 on the primary rays, 0.353 on the shadow rays).
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
# The point-GAN generator kernel (B7) vs its plain version on the same
# operands. Its LayerNorm sums run in another order than PyTorch's, so now
# and then an activation lands on the other side of a bf16 rounding and the
# flip spreads through the later layers: measured on the H100 max <= 4.4e-3,
# mean <= 1.4e-5 at the three shapes (output scale ~0.5; the mma.sync kernel
# read max <= 5.4e-3). The max bound only catches gross errors; four wrong
# kernels read mean >= 1.6e-3 (pre-norm sum rounded to bf16, variance without
# the mean, every row on item 0's latent rows, the row sums over half a
# quad; PERF.md, section 6), so the mean bound sits between.
GEN_MAX_ABS = 1e-2
GEN_MEAN_ABS = 1e-4
# One D step's fake cloud from the kernel against the bf16 module's (flax's
# rounding points) at the same latents: the JAX package's bound for its
# kernel against the module (tests/test_pallas_kernels.py:401).
GEN_VS_MODULE_MAX_ABS = 2e-2
# The stash forward kernel (B5a) against B1 and its plain version: its output
# must equal B1's bit for bit (the same arithmetic), and each stashed plane
# the plain version's by the share of differing bf16 elements and their
# largest difference. Measured on the H100 (both shapes, both sets): share
# 0, largest difference 0. A kernel that writes each plane one layer late
# differs on nearly every element (PERF.md, section 6). The stash backward
# (B5b) is held to B2's BWD_L2 / BWD_MAX against its plain version on the
# same planes: measured on the H100, L2 <= 6.7e-4 on every output and max
# <= 9.3e-4 on the summed ones at STASH_SETS; at STASH_CHECK_SETS, whose
# runs of rebuilt layers carry B2's own noise, L2 <= 2.6e-3 and max <=
# 8.1e-3; six wrong kernels (kernel_mutants.py) read L2 >= 8.3e-2.
STASH_PLANE_SHARE = 1e-4
STASH_PLANE_MAX = 0.1
# B2's rows pass alone (sdf_grid_backward_rows) against
# grid_backward_rows_plain: per h and dz plane the share of differing bf16
# elements and their largest difference over the plane's largest value; dx1
# and gz by max |d| over max |ref|. The wgmma products sum in another order
# than the plain matmul, so a few bf16 roundings flip and spread through the
# later planes, and a flipped mask moves a dz element by its whole value.
# Measured on the H100 (both cases): share <= 3.3e-3 (dz2), largest <= 0.73
# (dz7), dx1 <= 0.13, gz <= 1.9e-5; four wrong kernels (kernel_mutants.py)
# read shares >= 5.2e-2 on some plane (the product rounded before the bias,
# the backward mask from the layer's output, the backward's K-blocks at the
# wrong offset, a wrong descriptor offset). The share bound sits between;
# the others catch gross errors only.
ROWS_PLANE_SHARE = 1e-2
ROWS_PLANE_MAX = 1.0
ROWS_DX1_MAX = 0.5
ROWS_GZ_MAX = 1e-4
# B2's passes 2-4 alone (sdf_grid_backward_passes) against
# grid_backward_passes_plain (float64 sums) on the same planes: relative
# errors per output, ||d||_2 / ||ref||_2 and max|d| / max|ref|. Only the
# order of float32 sums differs, so these sit far below BWD_L2 / BWD_MAX:
# measured on the H100 <= 5.6e-5 (d_w over one 64^3 shape: 23,872-row
# slabs summed in the wgmma accumulators; 1.1e-6 over 818-row slabs at
# P=3001), <= 2.5e-6 elsewhere; wrong kernels (kernel_mutants.py) read
# >= 1e-2.
PASSES_L2 = 1e-3
PASSES_MAX = 1e-3
STASH_SETS = ((2, 4, 6), (1, 2, 3, 4, 5, 6))
FULL_STASH = STASH_SETS[-1]
# Stash sets held at phase 3 for correctness only, beside STASH_SETS: one
# for each branch of B5b's plan that those two do not take. A stashed input
# to the skip layer (3,), a stashed skip output (4,), h7 alone (6,), and a
# stashed position 0 (ignored) with a rebuilt run between stashed ones
# (0, 1, 5).
STASH_CHECK_SETS = ((3,), (4,), (6,), (0, 1, 5))
# The stash sets of the G-step A/B (the JAX package's bench_profile.py
# stash_breakdown sets).
AB_SETS = (None, (2, 4, 6), (1, 2, 4, 6), (1, 2, 3, 4, 5, 6))
# Sizes: the trace kernel's rays (the frame's 800^2 x ssaa 2), the demo's
# frames, and the hit-point check.
TRACE_SIZE = 1600
FRAME_RESOLUTION = 800
HIT_CHECK_SIZE = 400


# The runs of a path made with a switch away from its shipped setting (the
# A/B runs): their launches stay in the kernels line's launches_by_path but
# not in its launches, which count the shipped path only.
OFF_DEFAULT = set()


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
    from shapegan_tpu_torch.ops import point_gen_kernels as PG
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    return {"grid": K.grid_forward_cuda, "grid_bwd": K.grid_backward_cuda,
            "points": K.points_forward_cuda, "trace": K.trace_steps_cuda,
            "rowwise": K.rowwise_forward_cuda, "rowwise_bwd": K.rowwise_backward_cuda,
            "point_gen": PG.generate_cuda, "grid_stash": K.grid_forward_stash_cuda,
            "grid_stash_bwd": K.grid_backward_stash_cuda}


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


def compare(name: str, got, want, max_bound: float = KERNEL_MAX_ABS,
            mean_bound: float = KERNEL_MEAN_ABS) -> float:
    """Max-abs error of a kernel against its plain version; fails beyond
    the stated tolerances."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"finite={bool(torch.isfinite(got).all())}")
    diff = (got - want).abs()
    max_abs, mean_abs = float(diff.max()), float(diff.mean())
    log(f"  {name}: max_abs={max_abs:.3e} (<= {max_bound}) "
        f"mean_abs={mean_abs:.3e} (<= {mean_bound})")
    if not (max_abs <= max_bound and mean_abs <= mean_bound):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def same_bytes(name: str, call) -> None:
    """Phase 3: two calls of ``call`` (a kernel, its outputs as a sequence)
    give the same bytes."""
    import torch

    first, second = call(), call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two calls differ")
    log(f"  {name}: two calls give the same bytes")


def point_gen_case(batch: int, n: int, seed: int, device):
    """B7's operands for ``batch`` clouds of ``n`` uniform points in [-1, 1]^3
    and latents N(0, 1), from a generator with fresh full-width weights:
    (operands, the bf16 generator, its parameters, pos, z)."""
    import torch
    from shapegan_tpu_torch.ops import point_gen_kernels as PG
    from shapegan_tpu_torch.train import point_gan as T

    generator, _ = T.create_models(seed, device)
    params = {k: v.detach() for k, v in generator.named_parameters()}
    gen = torch.Generator().manual_seed(seed)
    pos = (torch.rand((batch, n, 3), generator=gen) * 2 - 1).to(device)
    z = torch.randn((batch, T.LATENT_SIZE), generator=gen).to(device)
    return PG.generate_operands(params, pos, z), generator, params, pos, z


def compare_backward(name: str, got, want, names=BWD_NAMES, per_row=("d_pp1", "d_pp5"), l2_bound=BWD_L2,
                     max_bound=BWD_MAX) -> float:
    """A backward kernel (B2, B6b, B2's passes 2-4) against its plain version
    by relative bounds (the per-row outputs exempt from the max bound);
    returns the largest absolute error over the outputs."""
    import torch

    torch.cuda.synchronize()
    worst_abs = 0.0
    readings = []
    for out, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name} {out}: shape {tuple(a.shape)} vs {tuple(b.shape)}, "
                                 f"finite={bool(torch.isfinite(a).all())}")
        d = (a.double() - b.double()).abs()
        l2 = float(d.norm() / b.double().norm())
        mx = float(d.max() / b.double().abs().max())
        worst_abs = max(worst_abs, float(d.max()))
        readings.append(f"{out} {l2:.2e}/{mx:.2e}")
        if l2 > l2_bound or (out not in per_row and mx > max_bound):
            raise AssertionError(f"{name} {out}: L2 {l2:.3e} (<= {l2_bound}), "
                                 f"max {mx:.3e} (<= {max_bound}): kernel disagrees with plain")
    log(f"  {name}: L2/max relative {', '.join(readings)}; max_abs={worst_abs:.3e}")
    return worst_abs


def compare_stash_forward(name: str, got, want, b1, stash) -> float:
    """B5a against B1 (its output, bit for bit) and against its plain
    version (the output by the kernel bounds, each plane by the share of
    differing elements and their largest difference); returns the output's
    max-abs error against the plain version."""
    import torch

    (out, planes), (plain_out, plain_planes) = got, want
    torch.cuda.synchronize()
    if not torch.equal(out, b1):
        raise AssertionError(f"{name}: the stash forward's output is not B1's")
    err = compare(name, out, plain_out)
    readings, wrong = [], []
    for j, a, b in zip(stash, planes, plain_planes):
        share = float((a != b).float().mean())
        largest = float((a.float() - b.float()).abs().max())
        readings.append(f"h{j + 1} {share:.2e}/{largest:.2e}")
        if a.shape != b.shape or not (share <= STASH_PLANE_SHARE and largest <= STASH_PLANE_MAX):
            wrong.append(j)
    log(f"  {name} planes (share differing / largest difference): {', '.join(readings)}; "
        f"output equal to B1's")
    if wrong:
        raise AssertionError(f"{name}: planes {wrong} disagree with the plain version's "
                             f"(share <= {STASH_PLANE_SHARE}, largest <= {STASH_PLANE_MAX})")
    return err


def rows_readings(got, want) -> dict:
    """B2's rows pass against its plain version: plane -> (share of
    differing elements, largest difference over the plane's largest value)
    for h1..h7 and dz2..dz7; dx1 and gz -> (0, max |d| over max |ref|)."""
    import torch

    torch.cuda.synchronize()
    (h, dz, dx1, gz), (ph, pdz, pdx1, pgz) = got, want
    pairs = [(f"h{j + 1}", h[j], ph[j]) for j in range(7)]
    pairs += [(f"dz{layer + 2}", dz[layer], pdz[layer]) for layer in range(6)]
    pairs += [("dx1", dx1, pdx1), ("gz", gz, pgz)]
    readings = {}
    for label, a, b in pairs:
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"rows {label}: shape {tuple(a.shape)} vs {tuple(b.shape)}, "
                                 f"finite={bool(torch.isfinite(a).all())}")
        diff = (a.float() - b.float()).abs()
        share = float((a != b).float().mean()) if a.dtype == torch.bfloat16 else 0.0
        readings[label] = (share, float(diff.max() / b.float().abs().max().clamp_min(1e-30)))
    return readings


def check_rows(name: str, readings: list) -> None:
    """Fails unless the worst of ``readings`` (rows_readings of each part of
    a case) holds the ROWS_* bounds."""
    worst = {label: tuple(max(r[label][i] for r in readings) for i in range(2)) for label in readings[0]}
    log(f"  {name} (share differing / largest difference, relative): "
        + ", ".join(f"{label} {s:.2e}/{m:.2e}" for label, (s, m) in worst.items()))
    wrong = [label for label, (share, largest) in worst.items()
             if share > ROWS_PLANE_SHARE or largest > {"dx1": ROWS_DX1_MAX, "gz": ROWS_GZ_MAX}.get(
                 label, ROWS_PLANE_MAX)]
    if wrong:
        raise AssertionError(f"{name}: {wrong} outside the bounds (share <= {ROWS_PLANE_SHARE}, "
                             f"planes <= {ROWS_PLANE_MAX}, dx1 <= {ROWS_DX1_MAX}, gz <= {ROWS_GZ_MAX})")


def shapes_of(ops, g, s: int, n: int = 1) -> tuple:
    """The grid operands and cotangent of shapes s .. s + n - 1."""
    pp1, pp5, zz1, zz5, w, b, w8 = ops
    return pp1, pp5, zz1[s:s + n], zz5[s:s + n], w, b, w8, g[s:s + n]


def rows_checks(ops, g) -> None:
    """Phase 3: B2's rows pass at one case (grid operands, cotangent), one
    shape a call when the batch exceeds one chunk."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    batch, points = g.shape
    step = 1 if batch * points > K.ROW_CAP else batch
    readings = []
    for s in range(0, batch, step):
        part = shapes_of(ops, g, s, step)
        readings.append(rows_readings(K.grid_backward_rows_cuda(*part), K.grid_backward_rows_plain(*part)))
        torch.cuda.empty_cache()
    check_rows(f"grid_bwd rows B={batch} P={points}", readings)


def passes_checks(ops, g) -> float:
    """Phase 3: B2's passes 2-4 alone on the rows pass's planes at one case,
    in B2's chunks (one shape a chunk when the batch exceeds one chunk; else
    the whole batch, and its last shapes as a chunk from s0 = 1); returns
    the largest absolute error."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    batch, points = g.shape
    step = 1 if batch * points > K.ROW_CAP else batch
    chunks = [(s, step) for s in range(0, batch, step)] + ([(1, batch - 1)] if step > 1 else [])
    worst_abs = 0.0
    for s0, n in chunks:
        planes = K.grid_backward_rows_cuda(*shapes_of(ops, g, s0, n))
        worst_abs = max(worst_abs, compare_backward(
            f"grid_bwd passes B={batch} P={points} chunk s0={s0} x {n}",
            K.grid_backward_passes_cuda(*planes, n, points, s0), K.grid_backward_passes_plain(*planes, n, points, s0),
            per_row=(), l2_bound=PASSES_L2, max_bound=PASSES_MAX))
        del planes
        torch.cuda.empty_cache()
    return worst_abs


# How often one call is recorded again when the profiler's trace lacks a
# kernel it must hold, and the quiet host time around the recorded call.
PROFILE_TRIES = 5
PROFILE_PAD_S = 0.005


def profiled_call(fn, needed=()):
    """torch.profiler's key_averages() of one call of fn, in which some CUDA
    kernel's name holds each part in ``needed``. The profiler can drop
    kernels of the recorded call, even in the step after a warm-up step, and
    drops them less with the card idle around the call
    (``python -m shapegan_tpu_torch.profiler_probe`` counts both ways). So
    the call is recorded in the step after a warm-up step with PROFILE_PAD_S
    of idle card on either side, and anew, up to PROFILE_TRIES times, while
    a part in ``needed`` is missing; then this fails."""
    import torch

    fn()
    torch.cuda.synchronize()
    missing = list(needed)
    for _ in range(PROFILE_TRIES):
        events = []
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                                    on_trace_ready=lambda prof: events.append(prof.key_averages())) as prof:
            for step in range(2):
                time.sleep(PROFILE_PAD_S * step)
                fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S * step)
                prof.step()
        keys = [e.key for e in events[0] if e.device_type == torch.autograd.DeviceType.CUDA]
        missing = [part for part in needed if not any(part in key for key in keys)]
        if not missing:
            return events[0]
        log(f"  (the profiler's trace of one call lacks {missing}; recording it again)")
    raise AssertionError(f"the profiler saw no kernel named like {missing} in {PROFILE_TRIES} recordings of one call")


def grid_bwd_split(fn) -> tuple:
    """Device time (ms, torch.profiler) of a grid backward's (B2's or B5b's)
    rows pass and of its passes 2-4 in one call of fn: the rows kernel of
    sdf_grid_bwd_sm90.cuh; the kernels of sdf_bwd_passes_sm90.cuh and the
    finishes (not the zeroing of the outputs)."""
    import torch

    events = [e for e in profiled_call(fn, needed=("bwd_rows_sm90_kernel", "sdf90_passes", "bwd_finish_kernel"))
              if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sum(e.self_device_time_total for e in events if "bwd_rows_sm90_kernel" in e.key)
    passes = sum(e.self_device_time_total for e in events
                 if "sdf90_passes" in e.key or "bwd_finish_kernel" in e.key)
    return rows / 1e3, passes / 1e3


# B6b's kernels by a part of their names in a torch.profiler trace: its rows
# pass, the weight kernel, the fixed-order finishes, the tail (dzz5 and the
# d_w8 / d_b8 sums) and the zeroing of the summed outputs.
ROWWISE_BWD_PASSES = {"rows": "bwd_rows_sm90_kernel", "weight": "weight_kernel", "finishes": "finish_kernel",
                      "tail": "tail_kernel", "zeroing": "Memset"}


def rowwise_bwd_split(fn) -> dict:
    """Device time (ms, torch.profiler) of one call of fn (B6b) by pass
    (ROWWISE_BWD_PASSES; "other": the rest, wt's transpose)."""
    import torch

    out = {name: 0.0 for name in list(ROWWISE_BWD_PASSES) + ["other"]}
    for e in profiled_call(fn, needed=tuple(ROWWISE_BWD_PASSES.values())):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k, key in ROWWISE_BWD_PASSES.items() if key in e.key), "other")
            out[name] += e.self_device_time_total / 1e3
    return out


def path_latents(device) -> tuple:
    """The bundled latent codes, and 16 codes on a Catmull-Rom path through
    them (slice A's) on the card."""
    import torch
    from shapegan_tpu_torch import checkpoints, demo_sdf_net
    from shapegan_tpu_torch.models import LATENT_CODES_FILENAME

    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base=os.path.join(REPO, "shapegan_tpu", "examples"))
    return codes, torch.tensor(demo_sdf_net.catmull_rom(codes, 2)[:16].astype("float32"), device=device)


def grid_cases(params, rand_params, latents16, grid64, odd_pts, device) -> dict:
    """Phase 3's B1 (and B5a) cases, name -> grid operands: the bundled
    weights at the main path's 16 x 64^3 and at B=3, P=3001; random weights
    at B=1 (one shape: the tile order's modulus 1) and at B=5, P=64 x 100 + 1
    (a one-row tail tile; 505 tiles, whose pairs do not divide over the
    SMs)."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    gen = torch.Generator().manual_seed(17)
    tail_pts = (torch.rand(64 * 100 + 1, 3, generator=gen) * 2.2 - 1.1).to(device)
    latents = torch.randn((6, 128), generator=gen).to(device)
    return {"B=16 P=64^3": K.grid_operands(params, grid64, latents16),
            "B=3 P=3001": K.grid_operands(params, odd_pts, latents16[:3]),
            "B=1 P=3001": K.grid_operands(rand_params, odd_pts, latents[:1]),
            "B=5 P=6401": K.grid_operands(rand_params, tail_pts, latents[1:])}


def grid_check(name: str, ops, sets=STASH_SETS) -> tuple:
    """Phase 3 at one B1 case: B1 against its plain version, then B5a at
    each stash set against B1 (bit for bit) and its plain version. Returns
    the largest errors (B1's, B5a's)."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    b1 = K.grid_forward_cuda(*ops)
    err = compare(f"grid {name}", b1, K.grid_forward_plain(*ops))
    stash_err = 0.0
    for stash in sets:
        stash_err = max(stash_err, compare_stash_forward(
            f"grid_stash {name} {stash}", K.grid_forward_stash_cuda(*ops, stash),
            K.grid_forward_stash_plain(*ops, stash), b1, stash))
        torch.cuda.empty_cache()
    return err, stash_err


def stash_case(params, points, batch: int, seed: int, device):
    """B5's operands for ``batch`` latents N(0, 1) over ``points``, and a
    cotangent N(0, 1): (grid operands, g)."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    gen = torch.Generator().manual_seed(seed)
    latents = torch.randn((batch, 128), generator=gen).to(device)
    g = torch.randn((batch, points.shape[0]), generator=gen).to(device)
    return K.grid_operands(params, points, latents), g


def stash_checks(cases: dict, sets=STASH_SETS + STASH_CHECK_SETS) -> tuple:
    """Phase 3: B5a and B5b at each case (name -> (grid operands, cotangent))
    and stash set; B5b runs on B5a's planes, and its plain version on the
    same planes. Returns the largest errors (B5a's output, B5b's outputs)."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    fwd_err = bwd_err = 0.0
    for name, (ops, g) in cases.items():
        b1 = K.grid_forward_cuda(*ops)
        for stash in sets:
            got = K.grid_forward_stash_cuda(*ops, stash)
            fwd_err = max(fwd_err, compare_stash_forward(
                f"grid_stash {name} {stash}", got, K.grid_forward_stash_plain(*ops, stash), b1, stash))
            planes = got[1]
            bwd_err = max(bwd_err, compare_backward(
                f"grid_stash_bwd {name} {stash}", K.grid_backward_stash_cuda(*ops, g, planes, stash),
                K.grid_backward_stash_plain(*ops, g, planes, stash)))
            del got, planes
            torch.cuda.empty_cache()
    return fwd_err, bwd_err


def bound(flops: float, nbytes: float):
    """(ms, "operations" or "bytes", flops): the least time the card could
    take for ``flops`` bf16 tensor-core operations that read and write
    ``nbytes``, the larger of the two, and the operations counted."""
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations", flops) if by_ops >= by_bytes else (by_bytes, "bytes", flops)


def trace_lane_steps(pts, dirs, status, escape, weights, kw) -> int:
    """The trunk evaluations the trace needs: the lanes still active before
    each of its k steps, summed (the plain version, one step at a time)."""
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    total = 0
    for _ in range(kw["k"]):
        active = int((status == K.TRACE_ACTIVE).sum())
        if active == 0:
            break
        total += active
        pts, status = K.trace_steps_plain(pts, dirs, status, escape, *weights, **dict(kw, k=1))
    return total


def rowwise_case(params, n: int, seed: int, device):
    """B6's operands for n points with codes gathered from a 64-row table
    (std 0.1), and a cotangent: (operands, g)."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    gen = torch.Generator().manual_seed(seed)
    table = torch.randn((64, 128), generator=gen) * 0.1
    rows = table[torch.randint(0, 64, (n,), generator=gen)]
    pts = torch.rand((n, 3), generator=gen) * 2 - 1
    g = torch.randn(n, generator=gen) / n
    zz1, zz5 = K.latent_terms(params, rows.to(device))
    return K.rowwise_operands(params, pts.to(device), zz1, zz5), g.to(device)


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
            if fused != default:
                OFF_DEFAULT.add(path)
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
    from shapegan_tpu_torch.train import hybrid_gan as HG
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
                # The G step's VJP is the one hybrid_gan._GRID_STASH picks: with None
                # B1 and B2 once a G step, else B5a and B5b; B1 once a D step.
                g_steps, d_steps = len(result["g_step_s"]), len(result["d_step_s"])
                want = dict.fromkeys(counts, 0)
                if HG._GRID_STASH is None:
                    want.update(grid=d_steps + g_steps, grid_bwd=g_steps)
                else:
                    want.update(grid=d_steps, grid_stash=g_steps, grid_stash_bwd=g_steps)
                check_counts(f"training iteration {iteration}", counts,
                             launched=[k for k, v in want.items() if v], idle=[k for k, v in want.items() if not v])
                if counts != want:
                    raise AssertionError(f"iteration {iteration}: launches {counts}, expected {want}")
                net = result["net"]
                if net.device.type != "cuda":
                    raise AssertionError(f"the generator lies on {net.device}")
        finally:
            os.chdir(cwd)
    return paths


def step_times() -> dict:
    """Phase 8: G-step and D-step medians (ms) at each resolution, on fresh
    random weights and batches, the G step through the default VJP
    (``hybrid_gan._GRID_STASH``)."""
    import torch
    from shapegan_tpu_torch import LATENT_CODE_SIZE
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import hybrid_gan as HG
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
            f"(batch 16, median of 5; G-step VJP: stash {HG._GRID_STASH})")
        del net, disc, batch
        torch.cuda.empty_cache()
    return times


def hybrid_gan_path() -> dict:
    """Phase 11: the hybrid GAN and hybrid WGAN trainers' entry points
    (synthetic=32, batch 8, 32^3) in temporary directories, epochs=1 and a
    ``continue`` to epochs=2, with the stash switch at its shipped setting
    (``hybrid_gan._GRID_STASH``) and the other way (off, or on with (1..6)
    when the shipped setting is off); returns the launch counts per
    run. With the switch on each G step launches B5a and B5b and no B2, each
    D (critic) step B1; off, each G step launches B1 and B2."""
    import csv
    import math

    import torch
    from shapegan_tpu_torch.core.config import parse_cli
    from shapegan_tpu_torch.train import hybrid_gan as HG
    from shapegan_tpu_torch.train import hybrid_wgan as HW

    paths = {}
    default = HG._GRID_STASH
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cwd = os.getcwd()
            try:
                for switch in (default, None if default else FULL_STASH):
                    HG._GRID_STASH = switch
                    for module, kind in ((HG, "hybrid GAN"), (HW, "hybrid WGAN")):
                        sub = os.path.join(tmp, f"{module.G_NAME}-{switch is not None}")
                        os.makedirs(sub)
                        os.chdir(sub)
                        for argv, epochs in ((["epochs=1"], 1), (["epochs=2", "continue"], 2)):
                            reset_counts()
                            t0 = time.perf_counter()
                            result = module.train(parse_cli(["synthetic=32", "batch_size=8", *argv]))
                            torch.cuda.synchronize()
                            seconds = time.perf_counter() - t0
                            path = f"{kind}, stash switch {'on' if switch else 'off'}, {' '.join(argv)}"
                            counts = paths[path] = read_counts()
                            if switch != default:
                                OFF_DEFAULT.add(path)
                            steps = result["steps"]
                            g_steps = result.get("g_steps", steps)
                            want = dict.fromkeys(counts, 0)
                            if switch:
                                want.update(grid=steps, grid_stash=g_steps, grid_stash_bwd=g_steps)
                            else:
                                want.update(grid=steps + g_steps, grid_bwd=g_steps)
                            with open(f"plots/{module.G_NAME.rsplit('_', 1)[0]}_training.csv") as f:
                                rows = [[float(v) for v in r] for r in csv.reader(f, delimiter=" ")]
                            files = [checkpoints_path(n) for n in (module.G_NAME, module.D_NAME,
                                                                   module.OPT_NAME)]
                            files += [checkpoints_path(n, e) for n in (module.G_NAME, module.D_NAME)
                                      for e in range(epochs)]
                            missing = [f for f in files if not os.path.exists(f)]
                            log(f"  {path}: {seconds:.2f} s (host clock), {steps} D steps, "
                                f"{g_steps} G steps, CSV {rows}")
                            check_counts(path, counts, launched=[k for k, v in want.items() if v],
                                         idle=[k for k, v in want.items() if not v])
                            if counts != want:
                                raise AssertionError(f"{path}: launches {counts}, expected {want}")
                            if (len(rows) != epochs or [r[0] for r in rows] != list(range(epochs))
                                    or any(len(r) != 4 for r in rows)
                                    or not all(math.isfinite(v) for r in rows for v in r)):
                                raise AssertionError(f"{path}: CSV rows {rows}")
                            if missing or steps != 4 or result["net"].device.type != "cuda":
                                raise AssertionError(f"{path}: files missing {missing}, {steps} steps, "
                                                     f"generator on {result['net'].device}")
                        os.chdir(cwd)
            finally:
                os.chdir(cwd)
    finally:
        HG._GRID_STASH = default
    return paths


def checkpoints_path(name: str, epoch=None) -> str:
    from shapegan_tpu_torch import checkpoints

    return checkpoints.get_filename(name, epoch=epoch, base="models")


def hybrid_grads_vs_float32(device) -> None:
    """Phase 11: the generator's gradients through the trainers'
    generate_volumes (8 x 32^3, the hybrid GAN's fresh weights, a random
    cotangent), with the stash switch off (B1, B2) and on (B5a, B5b, the
    shipped set ``hybrid_gan._GRID_STASH``, or (1..6) when it is off),
    against float32 truth (``sdf_mlp.apply_grid``, TF32 off) by the rule of
    the JAX package's tests/test_pallas_kernels.py: each VJP's error within
    twice the bf16 autograd path's plus 0.02. The two VJPs are not held
    against each other: their relu masks differ by one bf16 rounding."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.ops.coords import voxel_coordinates
    from shapegan_tpu_torch.profile_slice import apply_bf16_autograd
    from shapegan_tpu_torch.train import hybrid_gan as HG

    net = HG.create_states(0, device)[0]
    params = net.param_dict()
    gen = torch.Generator().manual_seed(12)
    z = torch.randn((8, 128), generator=gen).to(device)
    cot = torch.randn((8, 32**3), generator=gen).to(device)
    grid = voxel_coordinates(32, device=device)

    def grads(fn):
        return torch.autograd.grad((fn().reshape(8, -1) * cot).sum(), list(params.values()))

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    default = HG._GRID_STASH
    try:
        truth = grads(lambda: sdf_mlp.apply_grid(params, grid, z))
        pts = grid[None].expand(8, -1, -1).reshape(-1, 3)
        bf16 = grads(lambda: apply_bf16_autograd(params, pts, z.repeat_interleave(32**3, 0)))
        for switch in (None, default or FULL_STASH):
            HG._GRID_STASH = switch
            got = grads(lambda: HG.generate_volumes(net, grid, z, 32))
            margins = {}
            for key, t, b, v in zip(params, truth, bf16, got):
                scale = max(float(t.abs().max()), 1e-6)
                err_bf16 = float((b - t).abs().max()) / scale
                err = float((v - t).abs().max()) / scale
                margins[key] = (err, 2.0 * err_bf16 + 0.02)
            worst = max(margins, key=lambda k: margins[k][0] / margins[k][1])
            log(f"  G-step gradients vs float32, stash switch {switch}: worst {worst} error "
                f"{margins[worst][0]:.3e} (< {margins[worst][1]:.3e}, twice bf16 autograd's + 0.02)")
            if any(err >= limit for err, limit in margins.values()):
                raise AssertionError(f"stash switch {switch}: gradients vs float32 {margins}")
    finally:
        HG._GRID_STASH = default
        torch.backends.cuda.matmul.allow_tf32 = tf32


def stash_ab(kind: str) -> None:
    """The A/B behind ``_GRID_STASH``'s default: the progressive trainer's G
    step at 64^3, batch 16 (fresh weights), with the recompute VJP and each
    stash set of AB_SETS in turns, host clock after a synchronize, median
    (and range) of 5, and each setting's peak device memory over one step;
    then the hybrid GAN's G and D steps at 32^3, batch 8, switch off and on
    (the shipped set, or (1..6) when it is off)."""
    import torch
    from shapegan_tpu_torch import LATENT_CODE_SIZE
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import hybrid_gan as HG
    from shapegan_tpu_torch.train import hybrid_progressive_gan as T

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    default = HG._GRID_STASH

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def in_turns(steps: dict, rounds: int = 5) -> dict:
        for fn in steps.values():
            for _ in range(2):
                fn()
        times = {name: [] for name in steps}
        for _ in range(rounds):
            for name, fn in steps.items():
                times[name].append(host_ms(fn))
        return times

    try:
        net, disc = T.create_models(0, device)
        g_step, _ = T.make_steps(net, disc, RMSprop(net.param_dict(), T.LEARN_RATE),
                                 RMSprop(dict(disc.named_parameters()), T.LEARN_RATE), 3)

        def progressive(setting):
            def fn():
                HG._GRID_STASH = setting
                g_step(torch.randn((16, LATENT_CODE_SIZE), generator=gen, device=device), 1.0)
            return fn

        steps = {setting: progressive(setting) for setting in AB_SETS}
        times = in_turns(steps)
        for setting, fn in steps.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            t = times[setting]
            log(f"  progressive G step 64^3 x 16, {'recompute (B1 + B2)' if setting is None else f'stash {setting} (B5a + B5b)'}: "
                f"{statistics.median(t):.3f} ms (host clock, median of 5 in turns; range "
                f"{min(t):.3f}-{max(t):.3f}), peak memory {peak:.3f} GB ({kind})")
        del net, disc, g_step, steps
        torch.cuda.empty_cache()

        net, disc, g_opt, d_opt = HG.create_states(0, device)
        g_step, d_step = HG.make_steps(net, disc, g_opt, d_opt)
        batch = torch.rand((8, 32, 32, 32), generator=gen, device=device) * 0.2 - 0.1

        def hybrid(setting, which):
            def fn():
                HG._GRID_STASH = setting
                z = torch.randn((8, LATENT_CODE_SIZE), generator=gen, device=device)
                if which == "G":
                    g_step(z)
                else:
                    d_step(batch, z)
            return fn

        steps = {(setting, which): hybrid(setting, which)
                 for setting in (None, default or FULL_STASH) for which in ("G", "D")}
        for (setting, which), t in in_turns(steps).items():
            log(f"  hybrid GAN {which} step 32^3 x 8, stash switch {setting}: "
                f"{statistics.median(t):.3f} ms (host clock, median of 5 in turns; range "
                f"{min(t):.3f}-{max(t):.3f}; {kind})")
    finally:
        HG._GRID_STASH = default


def autodecoder_path() -> dict:
    """Phase 9: the autodecoder trainer's entry point in a temporary
    directory, two epochs and then one more with ``continue``; returns the
    launch counts per run and the step times."""
    import csv
    import math

    import numpy as np
    import torch
    from shapegan_tpu_torch import checkpoints
    from shapegan_tpu_torch.core.config import parse_cli
    from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
    from shapegan_tpu_torch.train import sdf_autodecoder as T

    common = ["synthetic=64", "pointcloud_size=200000", "nogui"]
    runs = (("autodecoder epochs 0-1", common + ["epochs=2"]),
            ("autodecoder continue, epoch 2", common + ["epochs=3", "continue"]))
    paths, step_ms, total_steps = {}, [], 0
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for path, argv in runs:
                reset_counts()
                t0 = time.perf_counter()
                result = T.train(parse_cli(argv))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = paths[path] = read_counts()
                steps = sum(result["steps"])
                total_steps += steps
                step_ms += result["step_ms"]
                log(f"  {path}: {seconds:.2f} s (first call, host clock, data made on the host "
                    f"included), steps per epoch {result['steps']}, ms/step "
                    f"{[round(t, 3) for t in result['step_ms']]}")
                check_counts(path, counts, launched=("rowwise", "rowwise_bwd"),
                             idle=("grid", "grid_bwd", "points", "trace"))
                if counts["rowwise"] != steps or counts["rowwise_bwd"] != steps:
                    raise AssertionError(f"{path}: {steps} steps but launches {counts}")
                if result["net"].device.type != "cuda":
                    raise AssertionError(f"the network lies on {result['net'].device}")
            with open("plots/sdf_net_training.csv") as f:
                rows = [[float(v) for v in r] for r in csv.reader(f, delimiter=" ")]
            snapshots = [checkpoints.get_filename(name, epoch=e, base="models")
                         for name in (T.NET_NAME, LATENT_CODES_FILENAME) for e in range(3)]
            files = [checkpoints.get_filename(n, base="models")
                     for n in (T.NET_NAME, LATENT_CODES_FILENAME, T.OPT_NAME)] + snapshots
            missing = [f for f in files if not os.path.exists(f)]
            table = checkpoints.load_array(LATENT_CODES_FILENAME, base="models")
            with np.load(checkpoints.get_filename(T.OPT_NAME, base="models")) as opt:
                counts_saved = (int(opt["net/0/count"]), int(opt["codes/0/count"]))
        finally:
            os.chdir(cwd)
    log(f"  CSV {rows}; table {table.shape}, std {float(table.std()):.3e}; optimizer counts "
        f"{counts_saved} after {total_steps} steps")
    if [r[0] for r in rows] != [0, 1, 2] or any(len(r) != 4 for r in rows):
        raise AssertionError(f"autodecoder CSV rows {rows}")
    if not all(math.isfinite(v) for r in rows for v in r) or not rows[-1][2] < rows[0][2]:
        raise AssertionError(f"autodecoder losses not finite or not falling: {rows}")
    if missing:
        raise AssertionError(f"autodecoder files missing: {missing}")
    if table.shape != (64, 128) or not np.isfinite(table).all():
        raise AssertionError(f"autodecoder latent table {table.shape}")
    if counts_saved != (total_steps, total_steps):
        raise AssertionError(f"optimizer counts {counts_saved}, steps {total_steps}")
    return {"paths": paths, "step_ms": step_ms}


def autodecoder_grads_vs_float32(device) -> None:
    """Phase 9: the gradients of one autodecoder step through the kernels
    (B6a, B6b) against the float32 reference math, by cosine."""
    import torch
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.train import sdf_autodecoder as T

    gen = torch.Generator().manual_seed(5)
    params = {k: v.to(device).requires_grad_(True)
              for k, v in sdf_mlp.init(torch.Generator().manual_seed(4)).items()}
    codes = (torch.randn((64, 128), generator=gen) * 1e-2).to(device).requires_grad_(True)
    points = (torch.rand((64 * 1000, 3), generator=gen) * 2 - 1).to(device)
    sdf = (torch.randn(64 * 1000, generator=gen) * 0.05).clamp(-0.1, 0.1).to(device)
    indices = torch.randint(0, 64 * 1000, (20000,), generator=gen).to(device)
    _, got, got_codes = T.loss_and_grads(params, codes, points, sdf, indices, 1000)
    _, want, want_codes = T.loss_and_grads(params, codes, points, sdf, indices, 1000,
                                           apply=sdf_mlp.apply)

    def cosine(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / (a.norm() * b.norm() + 1e-30))

    readings = {k: cosine(got[k], want[k]) for k in got}
    readings["latent table"] = cosine(got_codes, want_codes)
    worst = min(readings, key=readings.get)
    log(f"  one kernel step's gradients vs float32 reference (20000 rows): lowest cosine "
        f"{readings[worst]:.5f} ({worst}; >= {AUTODECODER_GRAD_COSINE})")
    if readings[worst] < AUTODECODER_GRAD_COSINE:
        raise AssertionError(f"autodecoder gradients disagree with float32: {readings}")


def point_gan_path() -> dict:
    """Phase 10: the point-set GAN trainer's entry point in temporary
    directories: epochs=1 and a ``continue`` to epochs=2 with the fused
    generator switch on, epochs=1 with it off; returns the launch counts
    per run and the first D step's kernel-vs-module reading."""
    import csv
    import math

    import torch
    from torch.func import functional_call
    from shapegan_tpu_torch.core.config import parse_cli
    from shapegan_tpu_torch.ops import point_gen_kernels as PG
    from shapegan_tpu_torch.train import point_gan as T

    readings = {}
    generate_best = T.generate_best

    def probe(generator, params, pos, z):
        """The trainer's generate_best, and once per run with the switch on,
        the bf16 module's cloud at the same parameters and latents (no
        kernel launch) against it."""
        fake = generate_best(generator, params, pos, z)
        if PG._FORCE_FUSED_GENERATE and "fake vs module" not in readings:
            module = functional_call(generator, params, (pos, z))
            readings["fake vs module"] = float((fake - module).abs().max())
            readings["probe shape"] = tuple(fake.shape)
        return fake

    # (path, directory, arguments, switch, CSV lines after, D steps). 64
    # shapes: 2, 2, 2, 2, 5 and 10 batches an epoch in the six stages. The
    # resume skips as many epochs as the CSV has lines, in the new run's
    # order (the JAX trainer's rule): with epochs=2 those are stages 1-3,
    # so it runs stages 4-6 twice, 34 steps.
    runs = (("point GAN epochs=1, switch on", "a", ["epochs=1"], True, 6, 23),
            ("point GAN continue to epochs=2, switch on", "a", ["epochs=2", "continue"], True, 12, 34),
            ("point GAN epochs=1, switch off", "b", ["epochs=1"], False, 6, 23))
    paths = {}
    default = PG._FORCE_FUSED_GENERATE
    T.generate_best = probe
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cwd = os.getcwd()
            try:
                for path, sub, argv, fused, csv_rows, want_steps in runs:
                    os.makedirs(os.path.join(tmp, sub), exist_ok=True)
                    os.chdir(os.path.join(tmp, sub))
                    PG._FORCE_FUSED_GENERATE = fused
                    readings.pop("fake vs module", None)
                    reset_counts()
                    t0 = time.perf_counter()
                    result = T.train(parse_cli(["synthetic=64", *argv]))
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    counts = paths[path] = read_counts()
                    if fused != default:
                        OFF_DEFAULT.add(path)
                    with open("plots/point_gan_training.csv") as f:
                        rows = [[float(v) for v in r] for r in csv.reader(f, delimiter=" ")]
                    files = [T.G_NAME, T.D_NAME, T.OPT_NAME]
                    missing = [n for n in files if not os.path.exists(os.path.join("models", n + ".npz"))]
                    steps = result["steps"]
                    log(f"  {path}: {seconds:.2f} s (first call, host clock, data made on the host "
                        f"included), {steps} D steps, {len(result['g_step_s'])} G steps; CSV rows "
                        f"{[(int(r[0]), int(r[1]), round(r[3], 6)) for r in rows]}")
                    check_counts(path, counts, launched=("point_gen",) if fused else (),
                                 idle=[k for k in counts if k != "point_gen" or not fused])
                    if fused and counts["point_gen"] != steps:
                        raise AssertionError(f"{path}: {steps} D steps but launches {counts}")
                    if len(rows) != csv_rows or any(len(r) != 4 for r in rows):
                        raise AssertionError(f"{path}: CSV rows {rows}")
                    if not all(math.isfinite(v) for r in rows for v in r) or missing:
                        raise AssertionError(f"{path}: losses {rows}, files missing {missing}")
                    if steps != want_steps or result["generator"].lin0.weight.device.type != "cuda":
                        raise AssertionError(f"{path}: {steps} steps (expected {want_steps}), "
                                             f"generator on {result['generator'].lin0.weight.device}")
                    if fused:
                        err = readings["fake vs module"]
                        log(f"  first D step's fake cloud {readings['probe shape']}: kernel vs bf16 "
                            f"module max_abs={err:.3e} (<= {GEN_VS_MODULE_MAX_ABS})")
                        if not err <= GEN_VS_MODULE_MAX_ABS:
                            raise AssertionError(f"{path}: the kernel's fake cloud is not the module's")
            finally:
                os.chdir(cwd)
    finally:
        T.generate_best = generate_best
        PG._FORCE_FUSED_GENERATE = default
    return paths


def point_gan_step_times(device, kind: str) -> None:
    """Phase 10: the D step (fused generator switch on and off) and the G
    step at 32 x 4096 points, host clock after a synchronize, median of 10;
    the trainer's steps/s at one D step and a fifth of a G step."""
    import torch
    from shapegan_tpu_torch.profile_slice import point_gan_steps

    ms = {}
    for name, fn in point_gan_steps(device).items():
        for _ in range(3):
            fn()
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
        log(f"  point GAN {name} at 32 x 4096: {ms[name]:.3f} ms (host clock after a synchronize, "
            f"median of 10; fresh weights; {kind})")
    for switch in ("on", "off"):
        step = ms[f"D step, switch {switch}"] + ms["G step"] / 5
        log(f"  switch {switch}: {1000 / step:.3f} steps/s (one D step and a fifth of a G step)")


def main() -> int:
    import torch
    from torch.func import functional_call

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from shapegan_tpu_torch import checkpoints, demo_sdf_net
    from shapegan_tpu_torch.examples import fit_chair
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.ops import _build, sdf_mlp
    from shapegan_tpu_torch.ops import point_gen_kernels as PG
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
    codes, latents16 = path_latents(device)
    grid64 = voxel_coordinates(64, device=device)
    grid128 = voxel_coordinates(128, device=device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    odd_pts = (torch.rand(3001, 3, generator=gen) * 2.2 - 1.1).to(device)

    log(f"== 3. kernels vs plain versions ({kind})")
    # B1, and B5a at each stash set, at four cases (grid_cases).
    rand_params = sdf_mlp.init(torch.Generator().manual_seed(1), device=device)
    b1_cases = grid_cases(params, rand_params, latents16, grid64, odd_pts, device)
    grid_err = stash_err = 0.0
    for name, ops in b1_cases.items():
        errs = grid_check(name, ops)
        grid_err, stash_err = max(grid_err, errs[0]), max(stash_err, errs[1])
    grid_ops, odd_ops = b1_cases["B=16 P=64^3"], b1_cases["B=3 P=3001"]
    del b1_cases
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
    odd_bwd_ops = K.grid_operands(rand_params, odd_pts, torch.randn((3, 128), generator=gen).to(device))
    g3 = torch.randn((3, 3001), generator=gen).to(device)
    bwd_err = max(bwd_err, compare_backward("grid_bwd B=3 P=3001",
                                            K.grid_backward_cuda(*odd_bwd_ops, g3),
                                            K.grid_backward_plain(*odd_bwd_ops, g3)))
    # B2's rows pass alone, its planes against the plain version's; its
    # passes 2-4 alone on those planes; B2 twice, the same bytes.
    rows_checks(grid_ops, g16)
    rows_checks(odd_bwd_ops, g3)
    passes_err = max(passes_checks(grid_ops, g16), passes_checks(odd_bwd_ops, g3))
    same_bytes("grid_bwd B=16 P=64^3", lambda: K.grid_backward_cuda(*grid_ops, g16))
    # B5a and B5b with random weights and latents at the G step's shape and
    # at the odd shape (sixteen chunks of one shape, and one chunk), the sets
    # of STASH_SETS and STASH_CHECK_SETS; random cotangents.
    stash_cases = {"B=16 P=64^3": stash_case(rand_params, grid64, 16, 13, device),
                   "B=3 P=3001": stash_case(rand_params, odd_pts, 3, 14, device)}
    fwd_err, stash_bwd_err = stash_checks(stash_cases)
    stash_err = max(stash_err, fwd_err)
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
    # B6a and B6b at the autodecoder's batch with the bundled weights, and at
    # an odd N with random weights.
    rowwise_cases = {n: rowwise_case(p, n, seed, device)
                     for n, p, seed in ((20000, params, 6), (3001, rand_params, 7))}
    rowwise_err = rowwise_bwd_err = 0.0
    for n, (ops, g) in rowwise_cases.items():
        rowwise_err = max(rowwise_err, compare(f"rowwise N={n}", K.rowwise_forward_cuda(*ops),
                                               K.rowwise_forward_plain(*ops)))
        rowwise_bwd_err = max(rowwise_bwd_err, compare_backward(
            f"rowwise_bwd N={n}", K.rowwise_backward_cuda(*ops, g),
            K.rowwise_backward_plain(*ops, g), ROWWISE_BWD_NAMES, ROWWISE_PER_ROW))
    # B6a's and B6b's 64-row tiles with random weights: a tail inside one
    # tile (1, 63), one-row tails (65, 129), fewer tiles than consumer
    # warpgroups; and two calls at 20,000 rows, the same bytes (B6b's sums
    # run in one fixed order).
    for n in (1, 63, 65, 129):
        ops, g = rowwise_case(rand_params, n, 20 + n, device)
        rowwise_err = max(rowwise_err, compare(f"rowwise N={n}", K.rowwise_forward_cuda(*ops),
                                               K.rowwise_forward_plain(*ops)))
        rowwise_bwd_err = max(rowwise_bwd_err, compare_backward(
            f"rowwise_bwd N={n}", K.rowwise_backward_cuda(*ops, g),
            K.rowwise_backward_plain(*ops, g), ROWWISE_BWD_NAMES, ROWWISE_PER_ROW))
    ops, g = rowwise_cases[20000]
    same_bytes("rowwise N=20000", lambda: [K.rowwise_forward_cuda(*ops)])
    same_bytes("rowwise_bwd N=20000", lambda: K.rowwise_backward_cuda(*ops, g))
    # B7 at the D step's shape (stage 3 of the curriculum), at an odd shape
    # with a tail tile and tiles spanning two items, and at 200 rows (fewer
    # tiles than consumer warpgroups, tiles spanning items); fresh weights;
    # two calls at the D step's shape, the same bytes.
    gen_cases = {(b, n): point_gen_case(b, n, seed, device)
                 for b, n, seed in ((32, 4096, 10), (3, 1000, 11), (2, 100, 13))}
    gen_err = 0.0
    for (b, n), (ops, *_rest) in gen_cases.items():
        gen_err = max(gen_err, compare(f"point_gen B={b} N={n}", PG.generate_cuda(*ops),
                                       PG.generate_plain(*ops), GEN_MAX_ABS, GEN_MEAN_ABS))
    ops = gen_cases[(32, 4096)][0]
    same_bytes("point_gen B=32 N=4096", lambda: [PG.generate_cuda(*ops)])

    log(f"== 4. times at the main path's shapes ({kind}; {smi})")
    trunk_flop = 2 * 6 * 256 * 256
    weight_bytes = 6 * 256 * 256 * 2 + 2 * 3 * 256 * 2 + 9 * 256 * 2  # w, w1p, w5p, b, w8
    times, bounds = {}, {}
    for name, kernel, plain, ops, n_points in (
        ("grid", K.grid_forward_cuda, K.grid_forward_plain, grid_ops, 16 * 64**3),
        ("points", K.points_forward_cuda, K.points_forward_plain, points_ops, 128**3),
    ):
        plain_ms = time_ms(lambda: plain(*ops), iters=5)
        kernel_ms = time_ms(lambda: kernel(*ops), iters=10)
        times[name] = (kernel_ms, plain_ms)
        # grid: pp1/pp5 [P, 256] bf16 and zz1/zz5 in, [B, P] float32 out; points:
        # xyz float32 in, [N] float32 out.
        moved = (2 * 64**3 * 512 + 2 * 16 * 512 + 16 * 64**3 * 4 if name == "grid"
                 else 128**3 * 16 + 2 * 512)
        bounds[name] = bound(n_points * trunk_flop, moved + weight_bytes)
        log(f"  {name}: kernel {kernel_ms:.3f} ms ({n_points / kernel_ms / 1e6:.3f} G pts/s, "
            f"{n_points * trunk_flop / kernel_ms / 1e9:.1f} trunk TFLOP/s) | "
            f"plain {plain_ms:.3f} ms ({n_points / plain_ms / 1e6:.3f} G pts/s) | "
            f"n={n_points} | bound {bounds[name][0]:.3f} ms ({bounds[name][1]})")
    # B2: 18 products of 256 x 256 per row (6 rebuild, 6 dh, 6 dW).
    plain_ms = time_ms(lambda: K.grid_backward_plain(*grid_ops, g16), iters=3, warmup=1)
    kernel_ms = time_ms(lambda: K.grid_backward_cuda(*grid_ops, g16), iters=5)
    times["grid_bwd"] = (kernel_ms, plain_ms)
    n_points = 16 * 64**3
    # pp1/pp5 and g in; d_pp1/d_pp5 float32, d_zz, d_w, d_b out.
    moved = 2 * 64**3 * 512 + n_points * 4 + 2 * 64**3 * 1024 + 6 * 256 * 256 * 4 + 16 * 2048
    bounds["grid_bwd"] = bound(n_points * 3 * trunk_flop, moved + 2 * weight_bytes)
    log(f"  grid_bwd: kernel {kernel_ms:.3f} ms ({n_points * 3 * trunk_flop / kernel_ms / 1e9:.1f} "
        f"TFLOP/s over the 18 products) | plain {plain_ms:.3f} ms | n={n_points} | "
        f"bound {bounds['grid_bwd'][0]:.3f} ms ({bounds['grid_bwd'][1]})")
    # B2's rows pass alone (16 one-shape calls): 12 products a row; h1..h7,
    # dz2..dz7 (bf16), dx1 (float32) and gz written, pp1, pp5 (one shape a
    # call: re-read per shape) and g read.
    def rows_pass():
        for s in range(16):
            K.grid_backward_rows_cuda(*shapes_of(grid_ops, g16, s))

    rows_ms = time_ms(rows_pass, iters=5)
    rows_bound = bound(n_points * 2 * trunk_flop, n_points * (7 * 512 + 6 * 512 + 1024 + 4 + 2 * 512 + 4)
                       + 2 * weight_bytes)
    rows_rate = n_points * 2 * trunk_flop / rows_ms / 1e9
    log(f"  grid_bwd rows pass: {rows_ms:.3f} ms ({rows_rate:.1f} TFLOP/s over its 12 products) | bound "
        f"{rows_bound[0]:.3f} ms ({rows_bound[1]}): {rows_bound[0] / rows_ms:.3f} of the bound's rate | "
        f"B2 {kernel_ms:.3f} ms, its other passes {kernel_ms - rows_ms:.3f} ms")
    # B2's passes 2-4: the device time of their kernels in one B2 call
    # (torch.profiler), and alone, sixteen one-shape chunks (as in B2) on one
    # shape's planes, s0 = 0 ... 15 (CUDA events; each call also zeroes its
    # outputs, 0.54 GB of d_pp, which B2 does once a call). They read h1..h7
    # and dz1..dz6 (bf16), dx1 and gz once, write d_pp1 / d_pp5 and the small
    # outputs once, and do the 6 weight products a row.
    in_call_rows_ms, passes_ms = grid_bwd_split(lambda: K.grid_backward_cuda(*grid_ops, g16))
    planes = K.grid_backward_rows_cuda(*shapes_of(grid_ops, g16, 0))
    alone_ms = time_ms(lambda: [K.grid_backward_passes_cuda(*planes, 1, 64**3, s) for s in range(16)],
                       iters=5)
    del planes
    torch.cuda.empty_cache()
    passes_bound = bound(n_points * trunk_flop, n_points * (13 * 512 + 1024 + 4) + 2 * 64**3 * 1024
                         + 6 * 256 * 256 * 4 + 16 * 2048 + 9 * 256 * 4)
    log(f"  grid_bwd passes 2-4: {passes_ms:.3f} ms of device time in a B2 call "
        f"({n_points * trunk_flop / passes_ms / 1e9:.1f} TFLOP/s over the 6 weight products; alone, with "
        f"their zeroing, {alone_ms:.3f} ms) | bound {passes_bound[0]:.3f} ms ({passes_bound[1]}): "
        f"{passes_bound[0] / passes_ms:.3f} of the bound's rate | B2 {kernel_ms:.3f} ms, its rows pass "
        f"{rows_ms:.3f} ms ({in_call_rows_ms:.3f} ms of device time in the B2 call)")
    # B5a and B5b at the G step's shape, beside B1 and B2 (above): B5a does
    # B1's products and writes B*P*512 bytes a stashed position; B5b does
    # 18 - s products a row (s stashed among h2..h7) and reads the planes.
    # B5b's rows pass (device time in one call, torch.profiler) does 12 - s
    # of them and moves B2's rows pass's bytes: each stashed plane it reads
    # is an h plane it does not write.
    from shapegan_tpu_torch.train.hybrid_gan import _GRID_STASH

    stash_ops, g_stash = stash_cases["B=16 P=64^3"]
    for stash in STASH_SETS:
        _, planes = K.grid_forward_stash_cuda(*stash_ops, stash)
        fwd = (time_ms(lambda: K.grid_forward_stash_cuda(*stash_ops, stash), iters=10),
               time_ms(lambda: K.grid_forward_stash_plain(*stash_ops, stash), iters=3, warmup=1))
        bwd = (time_ms(lambda: K.grid_backward_stash_cuda(*stash_ops, g_stash, planes, stash), iters=5),
               time_ms(lambda: K.grid_backward_stash_plain(*stash_ops, g_stash, planes, stash),
                       iters=3, warmup=1))
        stash_rows_ms, stash_passes_ms = grid_bwd_split(
            lambda: K.grid_backward_stash_cuda(*stash_ops, g_stash, planes, stash))
        del planes
        torch.cuda.empty_cache()
        plane_bytes = len(stash) * n_points * 512
        fwd_bound = bound(n_points * trunk_flop, 2 * 64**3 * 512 + 2 * 16 * 512 + n_points * 4
                          + weight_bytes + plane_bytes)
        rows_stashed = len(set(stash) - {0})
        bwd_bound = bound(n_points * (18 - rows_stashed) * trunk_flop / 6, moved + 2 * weight_bytes
                          + plane_bytes)
        stash_rows_bound = bound(n_points * (12 - rows_stashed) * trunk_flop / 6,
                                 n_points * (7 * 512 + 6 * 512 + 1024 + 4 + 2 * 512 + 4) + 2 * weight_bytes)
        if stash == (_GRID_STASH or FULL_STASH):  # the kernels line's: the trainers' set, else (1..6)
            times["grid_stash"], times["grid_stash_bwd"] = fwd, bwd
            bounds["grid_stash"], bounds["grid_stash_bwd"] = fwd_bound, bwd_bound
            stash_rows = {"rows_source": "shapegan_tpu_torch/ops/csrc/sdf_grid_bwd_sm90.cuh",
                          "rows_ms": stash_rows_ms, "rows_bound_ms": stash_rows_bound[0],
                          "rows_bound_by": stash_rows_bound[1], "passes_ms": stash_passes_ms}
        log(f"  grid_stash {stash}: kernel {fwd[0]:.3f} ms (B1 {times['grid'][0]:.3f}; "
            f"{n_points * trunk_flop / fwd[0] / 1e9:.1f} trunk TFLOP/s, {fwd_bound[0] / fwd[0]:.3f} of the "
            f"bound's rate) | plain {fwd[1]:.3f} ms | bound {fwd_bound[0]:.3f} ms ({fwd_bound[1]}); "
            f"grid_stash_bwd: kernel "
            f"{bwd[0]:.3f} ms (B2 {times['grid_bwd'][0]:.3f}; "
            f"{n_points * (18 - rows_stashed) * trunk_flop / 6 / bwd[0] / 1e9:.1f} TFLOP/s over its "
            f"{18 - rows_stashed} products, {bwd_bound[0] / bwd[0]:.3f} of the bound's rate) | plain "
            f"{bwd[1]:.3f} ms | bound {bwd_bound[0]:.3f} ms ({bwd_bound[1]}); its rows pass {stash_rows_ms:.3f} ms "
            f"of device time in one call ({stash_rows_bound[0] / stash_rows_ms:.3f} of its bound's rate, "
            f"{stash_rows_bound[0]:.3f} ms, {stash_rows_bound[1]}), passes 2-4 {stash_passes_ms:.3f} ms")
    del stash_cases, stash_ops, g_stash
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
    lane_steps = trace_lane_steps(pts, dirs, status, escape, chair_weights, kw)
    # points, directions, status in; points, status out.
    bounds["trace"] = bound(lane_steps * trunk_flop, pts.shape[0] * (12 + 12 + 4 + 12 + 4)
                            + weight_bytes)
    log(f"  trace bound: {lane_steps} lane-steps need evaluating (of {pts.shape[0] * kw['k']}), "
        f"{bounds['trace'][0]:.3f} ms ({bounds['trace'][1]})")
    n_evals = pts.shape[0] * kw["k"]
    log(f"  trace ({name}): kernel {kernel_ms:.3f} ms ({n_evals / kernel_ms / 1e6:.3f} G lane-steps/s) "
        f"| plain {plain_ms:.3f} ms | 20 points-kernel steps {b3_ms:.3f} ms "
        f"({n_evals / b3_ms / 1e6:.3f} G lane-steps/s) | lanes={pts.shape[0]}, "
        f"{int((status == 0).sum())} active at the start")
    # B6a and B6b at the autodecoder's reference batch and at 65,536 rows.
    # B6a: 6 products a row; xyz, zz1, zz5 in, [N] out. B6b: 17 products a
    # row; xyz, zz1, zz5, g in, dzz1, dzz5 float32 and the trunk's gradients out.
    rowwise_cases[65536] = rowwise_case(rand_params, 65536, 8, device)
    rowwise_split = {}
    for n in (20000, 65536):
        ops, g = rowwise_cases[n]
        fwd_bound = bound(n * trunk_flop, n * (12 + 1024 + 4) + weight_bytes)
        bwd_bound = bound(n * 17 * 2 * 256 * 256, n * (12 + 1024 + 4 + 2048) + 2 * weight_bytes
                          + 6 * 256 * 256 * 4 + 8 * 256 * 4 + 256 * 4)
        fwd = (time_ms(lambda: K.rowwise_forward_cuda(*ops), iters=20),
               time_ms(lambda: K.rowwise_forward_plain(*ops), iters=10))
        fwd_queued = time_ms(lambda: [K.rowwise_forward_cuda(*ops) for _ in range(10)], iters=10) / 10
        bwd = (time_ms(lambda: K.rowwise_backward_cuda(*ops, g), iters=20),
               time_ms(lambda: K.rowwise_backward_plain(*ops, g), iters=10))
        if n == 20000:  # the trainer's batch: the kernels line's figures
            times["rowwise"], times["rowwise_bwd"] = fwd, bwd
            bounds["rowwise"], bounds["rowwise_bwd"] = fwd_bound, bwd_bound
        log(f"  rowwise N={n}: kernel {fwd[0]:.4f} ms ({n * trunk_flop / fwd[0] / 1e9:.1f} TFLOP/s, "
            f"{fwd_bound[0] / fwd[0]:.3f} of the bound's rate; a call of ten back to back {fwd_queued:.4f} ms, "
            f"{fwd_bound[0] / fwd_queued:.3f}) | plain {fwd[1]:.4f} ms | bound {fwd_bound[0]:.4f} ms "
            f"({fwd_bound[1]})")
        log(f"  rowwise_bwd N={n}: kernel {bwd[0]:.4f} ms "
            f"({n * 17 * 2 * 256 * 256 / bwd[0] / 1e9:.1f} TFLOP/s over the 17 products) | "
            f"plain {bwd[1]:.4f} ms | bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        split = rowwise_split[n] = rowwise_bwd_split(lambda: K.rowwise_backward_cuda(*ops, g))
        log(f"  rowwise_bwd N={n} by pass (torch.profiler device time of one call, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"; {sum(split.values()):.4f} in all, of the call's {bwd[0]:.4f} by CUDA events")
    # B7 at the D step's two ends of the curriculum's middle: 32 x 4096
    # (stage 3; the kernels line's figures) and 6 x 32768 (stage 6), beside
    # the bf16 module (SDFGenerator with the fused switch off). Six 256 x 256
    # products and the two depth-3 position products a row, and the head;
    # xyz in and one float out a row, the weights and zz rows once.
    gen_cases[(6, 32768)] = point_gen_case(6, 32768, 12, device)
    gen_weight_bytes = 6 * 256 * 256 * 2 + 2 * 3 * 256 * 2 + 3 * 8 * 256 * 2 + 256 * 2
    for b, n in ((32, 4096), (6, 32768)):
        ops, generator, gen_params, pos, z = gen_cases[(b, n)]
        rows = b * n
        gen_bound = bound(2 * rows * (6 * 256 * 256 + 2 * 3 * 256 + 256),
                          rows * 16 + gen_weight_bytes + 2 * b * 256 * 2)
        with torch.no_grad():
            gen_times = (time_ms(lambda: PG.generate_cuda(*ops), iters=20),
                         time_ms(lambda: PG.generate_plain(*ops), iters=5),
                         time_ms(lambda: functional_call(generator, gen_params, (pos, z)), iters=10),
                         time_ms(lambda: [PG.generate_cuda(*ops) for _ in range(10)], iters=10) / 10)
        if (b, n) == (32, 4096):
            times["point_gen"], bounds["point_gen"] = gen_times[:2], gen_bound
        log(f"  point_gen {b} x {n}: kernel {gen_times[0]:.4f} ms "
            f"({2 * rows * 6 * 256 * 256 / gen_times[0] / 1e9:.1f} trunk TFLOP/s, {gen_bound[0] / gen_times[0]:.3f} "
            f"of the bound's rate; a call of ten back to back {gen_times[3]:.4f} ms, "
            f"{gen_bound[0] / gen_times[3]:.3f}) | plain {gen_times[1]:.4f} ms | bf16 module (switch off) "
            f"{gen_times[2]:.4f} ms | bound {gen_bound[0]:.4f} ms ({gen_bound[1]})")
    for name, (kernel_ms, _) in times.items():
        ms, by, flops = bounds[name]
        log(f"  {name}: {kernel_ms:.3f} ms, {flops / kernel_ms / 1e9:.1f} TFLOP/s of the operations "
            f"its bound counts, bound {ms:.3f} ms ({by}): {ms / kernel_ms:.3f} of the bound's rate")
    del grid_ops, odd_ops, points_ops, odd_points_ops, odd_bwd_ops, g16, g3, cases, ops
    del rowwise_cases, gen_cases
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
    log(f"== 9. autodecoder path: DeepSDF autodecoder, 64 shapes x 200,000 points, batch 20,000 "
        f"({kind}; {smi})")
    paths.update(autodecoder_path()["paths"])
    autodecoder_grads_vs_float32(device)
    from shapegan_tpu_torch.profile_slice import autodecoder_steps

    for name, fn in autodecoder_steps(device).items():
        for _ in range(3):
            fn()
        ms = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  autodecoder step ({name}): {statistics.median(ms):.3f} ms (host clock after a "
            f"synchronize, median of 20; fresh weights, random batches of 20000)")
    log(f"== 10. point-GAN path: point-set SDF GAN, 64 synthetic shapes, curriculum 1024 x 32 -> "
        f"32768 x 6 ({kind}; {smi})")
    paths.update(point_gan_path())
    point_gan_step_times(device, f"{kind}; {smi}")
    from shapegan_tpu_torch.train.hybrid_gan import _GRID_STASH

    log(f"== 11. hybrid GAN and hybrid WGAN paths, stash switch at its shipped setting {_GRID_STASH} and "
        f"the other way; the stash A/B ({kind}; {smi})")
    paths.update(hybrid_gan_path())
    hybrid_grads_vs_float32(device)
    stash_ab(f"{kind}; {smi}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    def kernel_entry(name, counter, source, replaces, err, **extra):
        # library_ms: no single PyTorch call computes an 8-layer MLP (or its
        # recompute backward, or K trace steps of it), so none is timed.
        # launches: the runs at the shipped switch settings only.
        return {"name": name, "route": "cuda", "source": f"shapegan_tpu_torch/ops/csrc/{source}",
                "replaces": f"shapegan_tpu/ops/{replaces}",
                "launches": sum(p[counter] for path, p in paths.items() if path not in OFF_DEFAULT),
                "launches_by_path": {path: p[counter] for path, p in paths.items() if p[counter]},
                "max_abs_err": err, "ms": times[counter][0], "plain_ms": times[counter][1],
                "bound_ms": bounds[counter][0], "bound_by": bounds[counter][1], "library_ms": None,
                **extra}

    kernels = [
        kernel_entry("sdf_grid", "grid", "sdf_grid.cu", "sdf_mlp_pallas.py:50", grid_err),
        kernel_entry("sdf_points", "points", "sdf_points.cu", "sdf_mlp_pallas.py:199", points_err),
        kernel_entry("sdf_grid_bwd", "grid_bwd", "sdf_grid_bwd.cu", "sdf_mlp_pallas.py:469", bwd_err,
                     rows_source="shapegan_tpu_torch/ops/csrc/sdf_grid_bwd_sm90.cuh", rows_ms=rows_ms,
                     rows_bound_ms=rows_bound[0], rows_bound_by=rows_bound[1],
                     passes_source="shapegan_tpu_torch/ops/csrc/sdf_bwd_passes_sm90.cuh",
                     passes_ms=passes_ms, passes_alone_ms=alone_ms, passes_bound_ms=passes_bound[0],
                     passes_bound_by=passes_bound[1],
                     passes_max_abs_err=passes_err),
        kernel_entry("sdf_trace", "trace", "sdf_trace.cu", "sdf_mlp_pallas.py:331", trace_err),
        kernel_entry("sdf_rowwise", "rowwise", "sdf_rowwise.cu", "sdf_mlp_pallas.py:1132",
                     rowwise_err),
        kernel_entry("sdf_rowwise_bwd", "rowwise_bwd", "sdf_rowwise_bwd.cu", "sdf_mlp_pallas.py:1141",
                     rowwise_bwd_err, rows_source="shapegan_tpu_torch/ops/csrc/sdf_grid_bwd_sm90.cuh",
                     passes_source="shapegan_tpu_torch/ops/csrc/sdf_bwd_passes_sm90.cuh",
                     passes_ms=rowwise_split[20000], passes_ms_65536=rowwise_split[65536]),
        kernel_entry("point_gen", "point_gen", "point_gen.cu", "point_gen_pallas.py:62", gen_err),
        kernel_entry("sdf_grid_stash", "grid_stash", "sdf_grid.cu", "sdf_mlp_pallas.py:748",
                     stash_err),
        kernel_entry("sdf_grid_stash_bwd", "grid_stash_bwd", "sdf_grid_bwd.cu",
                     "sdf_mlp_pallas.py:795", stash_bwd_err, **stash_rows),
    ]
    log(f"== wall time of the whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the generation slice's time goes, on one GPU.

    python -m shapegan_tpu_torch.profile_slice [iters=N] [slices=ABCDEFG]

With the bundled network at full width (slices A-C; it is not a trained
shape, so slice B's mesh is the sphere mask) and a chair fitted on the card
(slice D), it prints, beside the card's name and power limit:

* slice A, ``generate_volumes_inference`` on 16 codes at 64^3: the median
  wall time on the host clock (synchronized) and the grid kernel's median
  CUDA-event time on the same operands;
* slice B, one ``demo_sdf_net`` mesh frame at 128^3 / 256^2, split into
  its phases on the host clock (each synchronized), medians over ``iters``
  frames;
* ``torch.profiler`` over one ``get_mesh``: device time, the device's busy
  share of the wall time, and the operations that take the most device
  time;
* slice C, the progressive WGAN-GP trainer's steps at 64^3, batch 16
  (``make_steps`` of iteration 3, fresh weights): G-step and D-step medians
  on the host clock, and ``torch.profiler`` over one of each, as above;
* slice D, one raymarched frame (``render_image``, 800^2, ssaa 2, at most
  1000 iterations) of the chair fitted on the card
  (``shapegan_tpu_torch.examples.fit_chair``), with the fused trace switch
  off and on: its phases (primary trace, normals, shadow trace, shading and
  downsample, copy to the host) on the host clock, synchronized at each
  phase's end, medians over ``iters`` frames; and ``torch.profiler`` over
  one frame with the switch's default;
* slice E, one DeepSDF autodecoder step at the reference batch (20,000
  points, a 64-row latent table, full width): the trainer's step
  (``train.sdf_autodecoder.loss_and_grads`` through the rowwise kernels,
  then both Adams) beside the same step with autograd over bf16 ``torch``
  matmuls (:func:`apply_bf16_autograd`, the counterpart of the JAX
  package's production XLA step), medians of ``iters`` steps on the host
  clock and ``torch.profiler`` over one of each;
* slice F, the point-set GAN trainer's steps at 32 x 4096 points (stage 3
  of its curriculum, fresh full-width weights, a random batch): the D step
  with the fused generator switch on (the generator kernel makes the fake
  cloud) and off (the bf16 module), and the G step, medians of ``iters``
  on the host clock, and ``torch.profiler`` over one of each; the same for
  the refinement trainer's steps at 16 x 8192 points (its first stage);
* slice G, the activation stash at 16 x 64^3 (the counterpart of the JAX
  package's ``bench_profile.py stash_breakdown``, fresh full-width weights):
  the forward with the stash writes of (2,4,6) and (1..6) beside the grid
  kernel, and forward + backward (``apply_grid_trainable_stash``) for
  (2,4,6), (1,2,4,6) and (1..6) beside the recompute
  (``apply_grid_trainable``), each the median of ``iters`` on CUDA events
  and with its peak device memory;
* slice H, the voxel network family's steps at the root ``bench.py``'s
  shapes (:func:`voxel_steps`: the voxel GAN step, the WGAN's critic and
  generator steps at batch 64, the classic AE, VAE and classifier steps at
  batch 32, 32^3, fresh full-width weights, random volumes in [-1, 1]):
  medians of ``iters`` on the host clock, each step's peak device memory
  (above what was allocated before its models were made),
  and ``torch.profiler`` over one of each (cuDNN's convolutions; no hand
  kernel).

It needs CUDA and builds the kernels if they are not built yet. ``slices=EF``
(letters of ABCDEFGH) runs only those slices.
"""

from __future__ import annotations

import itertools
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.demo_sdf_net import catmull_rom, render_mesh, write_png
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.ops.mesh_extract import extract_mesh
from shapegan_tpu_torch.train.hybrid_gan import generate_volumes_inference

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "shapegan_tpu", "examples")


def _host_ms(fn: Callable[[], object]) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _event_ms(fn: Callable[[], object]) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def frame_phases(net: SDFNet, code: torch.Tensor, voxel_resolution: int, resolution: int,
                 png_path: str) -> Dict[str, float]:
    """One mesh frame, as ``demo_sdf_net`` renders it, timed phase by phase
    (host clock, ms)."""
    out: Dict[str, object] = {}
    size = 2.0

    def voxels():
        out["voxels"] = net.get_voxels(code, voxel_resolution)

    def extract():  # the rest of SDFNet.get_mesh
        padded = torch.nn.functional.pad(out["voxels"], (1,) * 6, value=1.0)
        vertices, faces = extract_mesh(padded, spacing=size / voxel_resolution)
        out["mesh"] = TriangleMesh(vertices - size / 2.0, faces)

    def render():
        out["image"] = render_mesh(out["mesh"], resolution)

    phases = {
        "get_voxels (points kernel, device)": _host_ms(voxels),
        "extract_mesh (device, copy to host)": _host_ms(extract),
        "render_mesh (mesh arrays + C++ rasterizer, host)": _host_ms(render),
        "write_png (host)": _host_ms(lambda: write_png(png_path, out["image"])),
    }
    phases["frame total"] = sum(phases.values())
    return phases


def profile_device(fn: Callable[[], object], top: int = 6):
    """torch.profiler over one fn() after a warm-up call: (wall ms, device
    ms, [(op, device ms)])."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _host_ms(fn)

    # Kernels and copies as the device ran them; a host operation's device
    # time repeats theirs, so only device-side events are counted.
    events = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events) / 1e3
    return wall, total, [(e.key, e.self_device_time_total / 1e3) for e in events[:top]]


def profile_generation(device: torch.device, iters: int) -> None:
    """Slices A and B: volume generation at 16 x 64^3 and one mesh frame at
    128^3 / 256^2 on the bundled network."""
    net = SDFNet(checkpoints.load("sdf_net", base=EXAMPLES, device=device))
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base=EXAMPLES)
    latents = torch.tensor(catmull_rom(codes, 2)[:16].astype(np.float32), device=device)
    grid = voxel_coordinates(64, device=device)

    wall = [_host_ms(lambda: generate_volumes_inference(net, grid, latents, 64))
            for _ in range(iters + 2)][2:]
    ops = K.grid_operands(net.param_dict(), grid, latents)
    kernel = [_event_ms(lambda: K.grid_forward_cuda(*ops)) for _ in range(iters + 2)][2:]
    del ops
    print(f"slice A, generate_volumes_inference 16 x 64^3: wall {statistics.median(wall):.3f} ms "
          f"(host clock, median of {iters}); grid kernel {statistics.median(kernel):.3f} ms "
          f"(CUDA events, median of {iters})")

    code = latents[0]
    with tempfile.TemporaryDirectory() as tmp:
        frames = [frame_phases(net, code, 128, 256, os.path.join(tmp, "frame.png"))
                  for _ in range(iters + 1)][1:]
    print(f"slice B, one mesh frame at 128^3 / 256^2, medians of {iters} (host clock, ms):")
    for phase in frames[0]:
        print(f"  {phase}: {statistics.median(f[phase] for f in frames):.3f}")

    report("one get_mesh at 128^3", *profile_device(lambda: net.get_mesh(code, 128)))


def main(argv: Optional[List[str]] = None) -> int:
    """The slices named in ``slices=`` (letters of ABCDEFGH; all by default)."""
    if not torch.cuda.is_available():
        print("profile_slice: CUDA is not available", file=sys.stderr)
        return 1
    extras = parse_cli(argv).extras
    iters = int(extras.get("iters", 5))
    slices = str(extras.get("slices", "ABCDEFGH")).upper()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi.splitlines()[0]}")
    for letters, profile in (("AB", profile_generation), ("C", profile_train_steps), ("D", profile_raymarch),
                             ("E", profile_autodecoder), ("F", profile_point_gan), ("G", profile_stash),
                             ("H", profile_voxel)):
        if any(letter in slices for letter in letters):
            profile(device, iters)
    return 0


def report(what: str, wall_ms: float, device_ms: float, top) -> None:
    print(f"torch.profiler, {what}: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
          f"busy share {device_ms / wall_ms:.3f}")
    for key, ms in top:
        print(f"  {ms:.3f} ms  {key}")


def profile_train_steps(device: torch.device, iters: int, iteration: int = 3) -> None:
    """Slice C: the trainer's G and D steps (batch 16) at
    ``RESOLUTIONS[iteration]``, with PyTorch's default TF32 settings."""
    from shapegan_tpu_torch import LATENT_CODE_SIZE
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import hybrid_progressive_gan as T

    res = T.RESOLUTIONS[iteration]
    net, disc = T.create_models(0, device)
    g_step, d_step = T.make_steps(net, disc, RMSprop(net.param_dict(), T.LEARN_RATE),
                                  RMSprop(dict(disc.named_parameters()), T.LEARN_RATE), iteration)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = torch.rand((16, res, res, res), generator=gen, device=device) * 0.2 - 0.1
    z = torch.randn((16, LATENT_CODE_SIZE), generator=gen, device=device)
    alpha = torch.rand((16, 1, 1, 1), generator=gen, device=device)
    steps = {"G step": lambda: g_step(z, 1.0), "D step": lambda: d_step(batch, z, alpha, 1.0)}
    for name, fn in steps.items():
        times = [_host_ms(fn) for _ in range(iters + 2)][2:]
        print(f"slice C, {name} at {res}^3, batch 16: {statistics.median(times):.3f} ms "
              f"(host clock, median of {iters})")
    for name, fn in steps.items():
        report(f"one {name} at {res}^3", *profile_device(fn, top=8))



def raymarch_phases(net: SDFNet, code: torch.Tensor, resolution: int) -> Dict[str, float]:
    """One ``render_image`` frame timed phase by phase (host clock, ms)."""
    from shapegan_tpu_torch.render import raymarching as rm

    phases: Dict[str, float] = {}
    torch.cuda.synchronize()
    start = last = time.perf_counter()

    def on_phase(name: str) -> None:
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        phases[name] = (now - last) * 1e3
        last = now

    rm.render_image(net, code, resolution=resolution, on_phase=on_phase)
    now = time.perf_counter()
    phases["copy to the host"] = (now - last) * 1e3
    phases["frame total"] = (now - start) * 1e3
    return phases


def profile_raymarch(device: torch.device, iters: int, resolution: int = 800) -> None:
    """Slice D: the raymarched frame of the fitted chair, per phase with the
    fused trace switch off and on, then torch.profiler over one frame."""
    from shapegan_tpu_torch.examples import fit_chair
    from shapegan_tpu_torch.render import raymarching as rm

    chair, code = fit_chair(device)
    net = SDFNet(chair)
    default = rm._FORCE_FUSED_TRACE
    try:
        for fused in (False, True):
            rm._FORCE_FUSED_TRACE = fused
            frames = [raymarch_phases(net, code, resolution) for _ in range(iters + 1)][1:]
            print(f"slice D, one raymarched frame at {resolution}^2 x ssaa 2, fused trace switch "
                  f"{fused}, medians of {iters} (host clock, ms):")
            for phase in frames[0]:
                print(f"  {phase}: {statistics.median(f[phase] for f in frames):.3f}")
    finally:
        rm._FORCE_FUSED_TRACE = default
    report(f"one raymarched frame at {resolution}^2 x ssaa 2 (fused trace switch {default})",
           *profile_device(lambda: rm.render_image(net, code, resolution=resolution), top=10))


def apply_bf16_autograd(params, points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """The DeepSDF MLP as plain autograd over bf16 ``torch`` matmuls, the
    counterpart of the JAX package's production autodecoder step
    (``sdf_mlp.apply`` with dtype bf16): bf16 fan-in sums, each trunk
    product's bf16 result plus a float32 bias, bf16 activations, a float32
    head. A yardstick for the trainer's kernel step; the port never calls
    it."""
    bf = torch.bfloat16
    pts, z = points.to(bf), latents.to(bf)
    p1 = pts @ params["w1p"].to(bf) + z @ params["w1z"].to(bf) + params["b1"].to(bf)
    p5 = pts @ params["w5p"].to(bf) + z @ params["w5z"].to(bf) + params["b5"].to(bf)
    x = torch.relu(p1)
    for key, extra in (("w2", params["b2"]), ("w3", params["b3"]), ("w4", params["b4"]),
                       ("w5h", p5.float()), ("w6", params["b6"]), ("w7", params["b7"])):
        x = torch.relu((x @ params[key].to(bf)).float() + extra).to(bf)
    return torch.tanh((x @ params["w8"].to(bf)).float() + params["b8"])[:, 0]


def autodecoder_steps(device: torch.device, batch: int = 20000, shapes: int = 64,
                      pointcloud_size: int = 200000, seed: int = 0) -> Dict[str, Callable[[], object]]:
    """One autodecoder step (gather, MLP forward and backward, both Adams)
    on fresh full-width weights, a ``shapes``-row table and random points,
    with a new random batch of indices each call: ``{"kernels": the
    trainer's step, "bf16 autograd": the yardstick}``."""
    from shapegan_tpu_torch import LATENT_CODE_SIZE
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.ops.sdf_mlp_kernels import apply_rowwise
    from shapegan_tpu_torch.optim import Adam
    from shapegan_tpu_torch.train import sdf_autodecoder as T

    gen = torch.Generator(device=device).manual_seed(seed)
    count = shapes * pointcloud_size
    points = torch.rand((count, 3), generator=gen, device=device) * 2 - 1
    sdf = (torch.randn(count, generator=gen, device=device) * 0.05).clamp(-T.SDF_CUTOFF, T.SDF_CUTOFF)
    steps = {}
    for name, apply in (("kernels", apply_rowwise), ("bf16 autograd", apply_bf16_autograd)):
        params = SDFNet(sdf_mlp.init(torch.Generator().manual_seed(seed), device=device)).param_dict()
        codes = (torch.randn((shapes, LATENT_CODE_SIZE), generator=gen, device=device)
                 * 1e-4).requires_grad_(True)
        net_opt, code_opt = Adam(params, T.LEARNING_RATE), Adam({"codes": codes}, T.LEARNING_RATE)

        def step(apply=apply, params=params, codes=codes, net_opt=net_opt, code_opt=code_opt):
            indices = torch.randint(0, count, (batch,), generator=gen, device=device)
            loss, net_grads, code_grad = T.loss_and_grads(params, codes, points, sdf, indices,
                                                          pointcloud_size, apply=apply)
            net_opt.step(net_grads)
            code_opt.step({"codes": code_grad})
            return loss

        steps[name] = step
    return steps


def profile_autodecoder(device: torch.device, iters: int) -> None:
    """Slice E: one autodecoder step at the reference batch, the trainer's
    (rowwise kernels) beside the bf16 autograd yardstick."""
    steps = autodecoder_steps(device)
    for name, fn in steps.items():
        times = [_host_ms(fn) for _ in range(iters + 3)][3:]
        print(f"slice E, autodecoder step ({name}), batch 20000: {statistics.median(times):.3f} ms "
              f"(host clock, median of {iters})")
    for name, fn in steps.items():
        report(f"one autodecoder step ({name})", *profile_device(fn, top=10))


def point_gan_steps(device: torch.device, batch: int = 32, points: int = 4096,
                    seed: int = 0) -> Dict[str, Callable[[], object]]:
    """The point GAN's steps (``train.point_gan.make_steps``) on fresh
    full-width models and one random batch of uniform samples, each call
    with new noise: ``{"D step, switch on", "D step, switch off", "G
    step"}``; the D steps set the fused generator switch for their call."""
    from shapegan_tpu_torch.ops import point_gen_kernels as PG
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import point_gan as T

    generator, critic = T.create_models(seed, device)
    d_step, g_step = T.make_steps(generator, critic,
                                  RMSprop(dict(generator.named_parameters()), T.LEARN_RATE),
                                  RMSprop(dict(critic.named_parameters()), T.LEARN_RATE))
    gen = torch.Generator(device=device).manual_seed(seed)
    u_pos = torch.rand((batch, points, 3), generator=gen, device=device) * 2 - 1
    u_dist = (torch.rand((batch, points, 1), generator=gen, device=device) - 0.5) * 0.2

    def d(fused: bool):
        default = PG._FORCE_FUSED_GENERATE
        PG._FORCE_FUSED_GENERATE = fused
        try:
            z = torch.randn((batch, T.LATENT_SIZE), generator=gen, device=device)
            alpha = torch.rand((batch, 1, 1), generator=gen, device=device)
            return d_step(u_pos, u_dist, z, alpha)
        finally:
            PG._FORCE_FUSED_GENERATE = default

    return {"D step, switch on": lambda: d(True), "D step, switch off": lambda: d(False),
            "G step": lambda: g_step(u_pos, torch.randn((batch, T.LATENT_SIZE), generator=gen,
                                                        device=device))}


def refinement_steps(device: torch.device, batch: int = 16, points: int = 8192,
                     seed: int = 0) -> Dict[str, Callable[[], object]]:
    """The refinement trainer's steps (``train.point_gan_ref.make_steps``)
    on fresh full-width models and one random real cloud (uniform points
    with their distances to a sphere of radius 0.5, surface points near it),
    each call with new noise: ``{"D step, switch on", "D step, switch off",
    "G step"}``; the D steps set the fused generator switch for their call."""
    from shapegan_tpu_torch.ops import point_gen_kernels as PG
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import point_gan_ref as R

    generator, critic = R.create_models(seed, device)
    d_step, g_step = R.make_steps(generator, critic,
                                  RMSprop(dict(generator.named_parameters()), R.LEARN_RATE),
                                  RMSprop(dict(critic.named_parameters()), R.LEARN_RATE))
    gen = torch.Generator(device=device).manual_seed(seed)
    u_pos = torch.rand((batch, points, 3), generator=gen, device=device) * 2 - 1
    s_pos = torch.nn.functional.normalize(u_pos, dim=-1) * 0.5
    real = (u_pos, u_pos.norm(dim=-1, keepdim=True) - 0.5, s_pos, s_pos.norm(dim=-1, keepdim=True) - 0.5)
    noise, step = torch.Generator(device=device), itertools.count(1)

    def d(fused: bool):
        default = PG._FORCE_FUSED_GENERATE
        PG._FORCE_FUSED_GENERATE = fused
        try:
            return d_step(real, R.step_noise(noise, seed, next(step), batch, points, device)[0])
        finally:
            PG._FORCE_FUSED_GENERATE = default

    return {"D step, switch on": lambda: d(True), "D step, switch off": lambda: d(False),
            "G step": lambda: g_step(u_pos, R.step_noise(noise, seed, next(step), batch, points,
                                                         device)[1])}


def profile_point_gan(device: torch.device, iters: int) -> None:
    """Slice F: the point GAN's D step (fused generator switch on and off)
    and G step at 32 x 4096 points, and the refinement trainer's at 16 x
    8192."""
    for what, steps in (("point GAN", point_gan_steps(device)),
                        ("refinement", refinement_steps(device))):
        shape = "32 x 4096" if what == "point GAN" else "16 x 8192"
        for name, fn in steps.items():
            times = [_host_ms(fn) for _ in range(iters + 2)][2:]
            print(f"slice F, {what} {name}, {shape} points: {statistics.median(times):.3f} ms "
                  f"(host clock, median of {iters})")
        for name, fn in steps.items():
            report(f"one {what} {name}", *profile_device(fn, top=10))


def voxel_steps(device: torch.device, seed: int = 0) -> Dict[str, Callable[[], Callable[[], object]]]:
    """The voxel family's steps at the root ``bench.py``'s shapes, 32^3, as
    builders: each makes its trainer's fresh full-width models, optimizers
    and one batch of uniform volumes in [-1, 1] on ``device`` and returns
    the step, which draws new noise each call. ``"GAN step"``: the voxel
    GAN's G step and two D steps (``train.gan.make_steps``), batch 64;
    ``"WGAN critic step"`` and ``"WGAN generator step"``, batch 64;
    ``"classic AE step"`` and ``"VAE step"``, batch 32; ``"classifier
    step"``, batch 32, 4 labels."""
    from shapegan_tpu_torch.models.classifier import Classifier
    from shapegan_tpu_torch.optim import Adam
    from shapegan_tpu_torch.train import autoencoder as AE
    from shapegan_tpu_torch.train import classifier as CL
    from shapegan_tpu_torch.train import gan as G
    from shapegan_tpu_torch.train import wgan as W

    gen = torch.Generator(device=device).manual_seed(seed)

    def volumes(batch: int) -> torch.Tensor:
        return torch.rand((batch, 32, 32, 32), generator=gen, device=device) * 2 - 1

    def latents(batch: int) -> torch.Tensor:
        return torch.randn((batch, 128), generator=gen, device=device)

    def gan():
        g_step, d_step = G.make_steps(*G.create_states(seed, device))
        real = volumes(64)

        def step():
            g_step(latents(64))
            return d_step(real, latents(64))
        return step

    def wgan(which: str):
        def build():
            critic_step, generator_step = W.make_steps(*W.create_states(seed, device))
            real = volumes(64)
            if which == "critic":
                return lambda: critic_step(real, latents(64))
            return lambda: generator_step(latents(64))
        return build

    def autoencoder(variational: bool):
        def build():
            step = AE.make_step(*AE.create_state(variational, seed, device))
            real = volumes(32)
            return lambda: step(real, latents(32))
        return build

    def classifier():
        model = Classifier(4, torch.Generator().manual_seed(seed), device)
        step = CL.make_step(model, Adam(dict(model.named_parameters()), CL.LEARNING_RATE))
        real = volumes(32)
        labels = torch.randint(0, 4, (32,), generator=gen, device=device, dtype=torch.int32)
        return lambda: step(real, labels)

    return {"GAN step": gan, "WGAN critic step": wgan("critic"),
            "WGAN generator step": wgan("generator"), "classic AE step": autoencoder(False),
            "VAE step": autoencoder(True), "classifier step": classifier}


def profile_voxel(device: torch.device, iters: int) -> None:
    """Slice H: the voxel family's steps (:func:`voxel_steps`), with
    PyTorch's default TF32 settings."""
    for name, build in voxel_steps(device).items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn = build()
        times = [_host_ms(fn) for _ in range(iters + 2)][2:]
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        print(f"slice H, {name}: {statistics.median(times):.3f} ms (host clock, median of {iters}), "
              f"peak memory {peak:.3f} GB")
        report(f"one {name}", *profile_device(fn, top=8))
        del fn


def profile_stash(device: torch.device, iters: int, batch: int = 16, res: int = 64) -> None:
    """Slice G: the activation stash at ``batch`` x ``res``^3, fresh weights;
    each figure the median of ``iters`` on CUDA events after a warm-up, with
    the peak device memory of one call (``max_memory_allocated`` after
    ``reset_peak_memory_stats``)."""
    from shapegan_tpu_torch.ops import sdf_mlp

    params = sdf_mlp.init(torch.Generator().manual_seed(0), device=device)
    grid = voxel_coordinates(res, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    z = torch.randn((batch, 128), generator=gen, device=device)
    print(f"slice G, activation stash at {batch} x {res}^3 ({batch * res**3 / 1e6:.2f}M points), "
          f"medians of {iters} (CUDA events)")

    def measure(name: str, fn: Callable[[], object]) -> float:
        fn()
        ms = statistics.median(_event_ms(fn) for _ in range(iters))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        print(f"  {name:<44s} {ms:9.3f} ms, peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        return ms

    ops = K.grid_operands(params, grid, z)
    fwd = measure("fwd (grid kernel, B1)", lambda: K.grid_forward_cuda(*ops))
    for stash in ((2, 4, 6), (1, 2, 3, 4, 5, 6)):
        ms = measure(f"fwd + stash writes {stash} (B5a)", lambda: K.grid_forward_stash_cuda(*ops, stash))
        print(f"    stash-write delta {stash}: {ms - fwd:.3f} ms")
    del ops

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    latents = z.clone().requires_grad_(True)

    def grad_step(apply):
        def fn():
            out = apply(leaves, grid, latents)
            return torch.autograd.grad(out.sum(), [*leaves.values(), latents])
        return fn

    recompute = measure("fwd+bwd recompute (B1 + B2)", grad_step(K.apply_grid_trainable))
    for stash in ((2, 4, 6), (1, 2, 4, 6), (1, 2, 3, 4, 5, 6)):
        ms = measure(f"fwd+bwd stash {stash} (B5a + B5b)",
                     grad_step(lambda p, g, l, s=stash: K.apply_grid_trainable_stash(p, g, l, s)))
        print(f"    vs recompute {stash}: {ms - recompute:.3f} ms")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

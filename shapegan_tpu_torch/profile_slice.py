#!/usr/bin/env python3
"""Where the generation slice's time goes, on one GPU.

    python -m shapegan_tpu_torch.profile_slice [iters=N]

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
  clock and ``torch.profiler`` over one of each.

It needs CUDA and builds the kernels if they are not built yet.
"""

from __future__ import annotations

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


def main(argv: Optional[List[str]] = None) -> int:
    if not torch.cuda.is_available():
        print("profile_slice: CUDA is not available", file=sys.stderr)
        return 1
    iters = int(parse_cli(argv).extras.get("iters", 5))
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi.splitlines()[0]}")

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
    profile_train_steps(device, iters)
    profile_raymarch(device, iters)
    profile_autodecoder(device, iters)
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


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

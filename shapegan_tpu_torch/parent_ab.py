#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's, in turns, on one
GPU:

    python -m shapegan_tpu_torch.parent_ab OTHER_ROOT

OTHER_ROOT is the root of another commit's tree (for example the parent,
unpacked with ``git archive`` into a git-ignored directory). The turns run
OTHER, this, this, OTHER; each is a fresh process (``python -P``, with the
turn's root alone on ``PYTHONPATH``) that imports ``shapegan_tpu_torch`` and
``chip_smoke.py`` from its root, builds that root's kernels, and prints one
JSON line:

* at 16 x 64^3 with the bundled weights: the grid backward B2 (CUDA events,
  median of 5) and its passes (``torch.profiler``, device time of one call by
  kernel name: the rows pass, the weight pass, the column sums with their
  fixed-order finish, the shape sums), and the grid forward B1;
* the stash forward B5a and the stash backward B5b (stash set (1..6),
  random weights) at 16 x 64^3, B5b on the plain version's planes (so its
  inputs do not depend on the tree's B5a);
* the points kernel B3 at 128^3 and the trace kernel B4 at 1600^2 x k=20 on
  the chair fitted on the card;
* ``render_image`` 800^2 x ssaa 2 with the fused trace on (host clock after
  a synchronize, median of the last 3 of 4);
* a SHA-256 of B3's, B4's (chip_smoke's three trace cases), B2's rows
  pass's (one 64^3 shape, its scratch planes) and B5b's outputs on fixed
  inputs: equal digests mean bit-identical results.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

TURNS = ("other", "this", "this", "other")
THIS_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _b2_passes(fn) -> dict:
    """Device time (ms) of one call of fn by the grid backward's passes."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {"rows": ("rows",), "weight": ("weight",), "colsum": ("colsum", "finish"),
              "shape_sum": ("shape_sum",)}
    out = {name: 0.0 for name in list(groups) + ["other"]}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        out[name] += e.self_device_time_total / 1e3
    return out


def measure() -> dict:
    import importlib.util

    import torch
    from shapegan_tpu_torch import checkpoints
    from shapegan_tpu_torch.examples import fit_chair
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.ops.coords import voxel_coordinates
    from shapegan_tpu_torch.render import raymarching as rm

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(K.__file__))))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    params = checkpoints.load("sdf_net", base=os.path.join(root, "shapegan_tpu", "examples"), device=device)
    latents = (torch.randn((16, 128), generator=gen) * 0.1).to(device)
    ops = K.grid_operands(params, voxel_coordinates(64, device=device), latents)
    g16 = torch.randn((16, 64**3), generator=gen).to(device)
    out = {"root": root}
    out["b1_ms"] = cs.time_ms(lambda: K.grid_forward_cuda(*ops), iters=10)
    out["b2_ms"] = cs.time_ms(lambda: K.grid_backward_cuda(*ops, g16), iters=5)
    out["b2_passes_ms"] = _b2_passes(lambda: K.grid_backward_cuda(*ops, g16))
    out["b2_rows_digest"] = _digest(*K.grid_backward_rows_cuda(*cs.shapes_of(ops, g16, 3)))
    del ops
    torch.cuda.empty_cache()

    stash = (1, 2, 3, 4, 5, 6)
    sops, g = cs.stash_case(sdf_mlp.init(torch.Generator().manual_seed(1), device=device),
                            voxel_coordinates(64, device=device), 16, 13, device)
    out["b5a_ms"] = cs.time_ms(lambda: K.grid_forward_stash_cuda(*sops, stash), iters=10)
    torch.cuda.empty_cache()
    planes = K.grid_forward_stash_plain(*sops, stash)[1]
    out["b5b_digest"] = _digest(*K.grid_backward_stash_cuda(*sops, g, planes, stash))
    out["b5b_ms"] = cs.time_ms(lambda: K.grid_backward_stash_cuda(*sops, g, planes, stash), iters=5)
    del sops, planes
    torch.cuda.empty_cache()

    folded = sdf_mlp.fold_latent(params, latents[0])
    pops = K.points_operands(folded, voxel_coordinates(128, device=device), latents[0, :0])
    out["b3_digest"] = _digest(K.points_forward_cuda(*pops))
    out["b3_ms"] = cs.time_ms(lambda: K.points_forward_cuda(*pops), iters=10)

    chair, code = fit_chair(device)
    chair_folded = sdf_mlp.fold_latent(chair, code)
    weights = K.point_weights(chair_folded, code[:0])
    cases = cs.trace_cases(chair_folded, device)
    outs = []
    for _name, pts, dirs, status, escape, kw in cases:
        outs += list(K.trace_steps_cuda(pts, dirs, status, escape, *weights, **kw))
    out["b4_digest"] = _digest(*outs)
    _name, pts, dirs, status, escape, kw = cases[0]
    out["b4_ms"] = cs.time_ms(lambda: K.trace_steps_cuda(pts, dirs, status, escape, *weights, **kw), iters=10)
    del cases, outs
    torch.cuda.empty_cache()

    net = SDFNet(chair)
    rm._FORCE_FUSED_TRACE = True
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rm.render_image(net, code, resolution=800)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["frame_ms"] = statistics.median(times[1:])
    return out


def main(argv) -> int:
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure()), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"parent_ab: {smi}; other {other}, this {THIS_ROOT}", flush=True)
    results = []
    for turn in TURNS:
        root = other if turn == "other" else THIS_ROOT
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-P", os.path.abspath(__file__), "--measure"], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["turn"] = turn
        results.append(result)
        print(f"{turn}: {json.dumps(result)} ({time.perf_counter() - t0:.1f} s with its build)", flush=True)
    for key in ("b2_ms", "b1_ms", "b5a_ms", "b5b_ms", "b3_ms", "b4_ms", "frame_ms"):
        print(f"  {key}: " + " / ".join(f"{r[key]:.3f}" for r in results))
    for name in results[0]["b2_passes_ms"]:
        print(f"  b2 {name}: " + " / ".join(f"{r['b2_passes_ms'][name]:.3f}" for r in results))
    for key in ("b3_digest", "b4_digest", "b2_rows_digest", "b5b_digest"):
        same = len({r[key] for r in results}) == 1
        print(f"  {key}: {'equal in every turn' if same else 'DIFFERS: ' + str([r[key] for r in results])}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's, in turns, on one
GPU:

    python -m shapegan_tpu_torch.parent_ab OTHER_ROOT [GROUP ...]

OTHER_ROOT is the root of another commit's tree (for example the parent,
unpacked with ``git archive`` into a git-ignored directory). The turns run
OTHER, this, this, OTHER; each is a fresh process (``python -P``, with the
turn's root alone on ``PYTHONPATH``) that imports ``shapegan_tpu_torch`` and
``chip_smoke.py`` from its root, builds that root's kernels, and prints one
JSON line of the named groups' readings (all four by default; see
``measure``):

* at 16 x 64^3 with the bundled weights: the grid backward B2 (CUDA events,
  median of 5) and its passes (``torch.profiler``, device time of one call by
  kernel name: the rows pass, the weight pass, the fan-in, the column sums,
  the fixed-order finishes, the shape sums: the parent's passes or this
  tree's), and the grid forward B1;
* the stash forward B5a and the stash backward B5b (stash set (1..6),
  random weights) at 16 x 64^3, B5b on the plain version's planes (so its
  inputs do not depend on the tree's B5a), also at (2,4,6), and B5b's rows
  pass's device time in one call (``torch.profiler``); ptxas's spill
  stores and registers of the rows-pass kernels in the turn's build (the
  instances of ``bwd_rows_sm90_kernel`` over GridInputs, StashInputs (the
  full plan's, ``ILb1``, and the run-time plan's, ``ILb0``) and RowInputs, or
  an older tree's mma.sync ``bwd_rows_kernel``);
* the points kernel B3 at 128^3 and the trace kernel B4 at 1600^2 x k=20 on
  the chair fitted on the card;
* ``render_image`` 800^2 x ssaa 2 with the fused trace on (host clock after
  a synchronize, median of the last 3 of 4);
* the rowwise backward B6b at 20,000 and 65,536 rows (chip_smoke's
  ``rowwise_case``, the bundled weights; CUDA events, median of 20), the
  host time to issue one call at 20,000 rows (no synchronize inside, median
  of 20), and its passes at 20,000 rows (``torch.profiler`` device time by
  kernel name: the rows pass, the weight pass, the column sums, the
  finishes, the tail (dzz5 and the d_w8 / d_b8 sums), the zeroing);
* the rowwise forward B6a at 20,000 rows and the point generator B7 at 32 x
  4096 (CUDA events, median of 20), and ptxas's spill stores and registers
  of both kernels in the turn's build;
* one autodecoder step at 20,000 points (``profile_slice``'s slice E: the
  trainer's step through B6a and B6b, and the bf16 autograd yardstick in
  the same process): host clock after a synchronize, median of 20 after 3,
  and the kernel step's device time (``torch.profiler``, all kernels);
* a SHA-256 of B3's, B4's (chip_smoke's three trace cases), B2's rows
  pass's (one 64^3 shape, its scratch planes), B5b's (both sets) and B6b's
  (both sizes) outputs on fixed inputs: equal digests mean bit-identical
  results.
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


B2_PASSES = {"rows": ("rows",), "weight": ("weight",), "fan_in": ("fan_in",), "colsum": ("colsum",),
             "finish": ("finish",), "shape_sum": ("shape_sum",)}
B6B_PASSES = {"rows": ("rows",), "weight": ("weight",), "colsum": ("colsum",), "finish": ("finish",),
              "tail": ("tail_kernel",), "zeroing": ("Memset",)}


def _passes(fn, groups) -> dict:
    """Device time (ms) of one call of fn by kernel name: groups maps a
    pass to the parts of the names of its kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    # The call in the step after a warm-up one, with 5 ms of idle card on
    # either side: without them the profiler dropped kernels of the recorded
    # call (chip_smoke.profiled_call).
    events = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                                on_trace_ready=lambda prof: events.append(prof.key_averages())) as prof:
        for step in range(2):
            time.sleep(0.005 * step)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.005 * step)
            prof.step()
    out = {name: 0.0 for name in list(groups) + ["other"]}
    for e in events[0]:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        out[name] += e.self_device_time_total / 1e3
    return out


def _host_issue_us(fn, iters: int = 20) -> float:
    """Median host time (us) to issue fn() on an idle card: from a
    synchronize to fn's return, with no synchronize inside."""
    import torch

    times = []
    for _ in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times[2:])


def _spills(kernels) -> dict:
    """ptxas's report (-v) in this turn's build: {kernel: [bytes of spill
    stores a thread, registers]} for each kernel whose mangled name holds
    a name in ``kernels``."""
    import re

    from shapegan_tpu_torch.ops import _build

    lines = _build.build_log().splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        name = next((k for k in kernels if m and k in m.group(1)), None)
        if name:
            text = " ".join(lines[i + 1:i + 4])
            spill, regs = re.search(r"(\d+) bytes spill stores", text), re.search(r"Used (\d+) registers", text)
            out[name] = [int(spill.group(1)) if spill else None, int(regs.group(1)) if regs else None]
    return out


def _autodecoder(out: dict, device) -> None:
    """Slice E's step, host clock and device time (see the module doc)."""
    import torch
    from shapegan_tpu_torch import profile_slice

    steps = profile_slice.autodecoder_steps(device)
    for name, key in (("kernels", "ad_step_ms"), ("bf16 autograd", "ad_bf16_step_ms")):
        times = []
        for _ in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[name]()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[key] = statistics.median(times[3:])
    out["ad_step_device_ms"] = sum(_passes(steps["kernels"], {}).values())


GROUPS = ("grid", "stash", "rowwise", "chair")


def measure(groups=GROUPS) -> dict:
    """One turn's readings of the named groups: grid (B1, B2, its passes,
    the rows pass's digest), stash (B5a, B5b), rowwise (B6b, B6a, B7, the
    autodecoder step), chair (B3, B4, the frame)."""
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
    out = {"root": root}
    if "grid" in groups:
        ops = K.grid_operands(params, voxel_coordinates(64, device=device), latents)
        g16 = torch.randn((16, 64**3), generator=gen).to(device)
        out["b1_ms"] = cs.time_ms(lambda: K.grid_forward_cuda(*ops), iters=10)
        out["b2_ms"] = cs.time_ms(lambda: K.grid_backward_cuda(*ops, g16), iters=5)
        out["b2_passes_ms"] = _passes(lambda: K.grid_backward_cuda(*ops, g16), B2_PASSES)
        out["b2_rows_digest"] = _digest(*K.grid_backward_rows_cuda(*cs.shapes_of(ops, g16, 3)))
        del ops
        torch.cuda.empty_cache()

    if "stash" in groups:
        sops, g = cs.stash_case(sdf_mlp.init(torch.Generator().manual_seed(1), device=device),
                                voxel_coordinates(64, device=device), 16, 13, device)
        out["b5a_ms"] = cs.time_ms(lambda: K.grid_forward_stash_cuda(*sops, (1, 2, 3, 4, 5, 6)), iters=10)
        torch.cuda.empty_cache()
        for stash, key in (((1, 2, 3, 4, 5, 6), "b5b"), ((2, 4, 6), "b5b_246")):
            planes = K.grid_forward_stash_plain(*sops, stash)[1]
            out[f"{key}_digest"] = _digest(*K.grid_backward_stash_cuda(*sops, g, planes, stash))
            out[f"{key}_ms"] = cs.time_ms(lambda: K.grid_backward_stash_cuda(*sops, g, planes, stash), iters=5)
            out[f"{key}_rows_ms"] = _passes(lambda: K.grid_backward_stash_cuda(*sops, g, planes, stash),
                                            {"rows": ("bwd_rows",)})["rows"]
            del planes
            torch.cuda.empty_cache()
        out["rows_spills"] = _spills(("GridInputs", "StashInputsILb1", "StashInputsILb0", "RowInputs",
                                      "bwd_rows_kernel"))
        del sops
        torch.cuda.empty_cache()

    if "rowwise" in groups:
        from shapegan_tpu_torch.ops import point_gen_kernels as PG

        for n in (20000, 65536):
            rops, rg = cs.rowwise_case(params, n, 6, device)
            out[f"b6b_{n}_ms"] = cs.time_ms(lambda: K.rowwise_backward_cuda(*rops, rg), iters=20)
            out[f"b6b_{n}_digest"] = _digest(*K.rowwise_backward_cuda(*rops, rg))
            if n == 20000:
                out["b6b_passes_ms"] = _passes(lambda: K.rowwise_backward_cuda(*rops, rg), B6B_PASSES)
                out["b6b_20000_host_us"] = _host_issue_us(lambda: K.rowwise_backward_cuda(*rops, rg))
                out["b6a_ms"] = cs.time_ms(lambda: K.rowwise_forward_cuda(*rops), iters=20)
        del rops, rg
        gops = cs.point_gen_case(32, 4096, 3, device)[0]
        with torch.no_grad():
            out["b7_ms"] = cs.time_ms(lambda: PG.generate_cuda(*gops), iters=20)
        del gops
        out["b6a_b7_spills"] = _spills(("sdf_rowwise_kernel", "point_gen_kernel"))
        _autodecoder(out, device)
        torch.cuda.empty_cache()

    if "chair" in groups:
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
        out["b4_ms"] = cs.time_ms(lambda: K.trace_steps_cuda(pts, dirs, status, escape, *weights, **kw),
                                  iters=10)
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
        print(json.dumps(measure(argv[1:] or GROUPS)), flush=True)
        return 0
    if not argv or any(group not in GROUPS for group in argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    other, groups = os.path.abspath(argv[0]), argv[1:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"parent_ab: {smi}; other {other}, this {THIS_ROOT}", flush=True)
    results = []
    for turn in TURNS:
        root = other if turn == "other" else THIS_ROOT
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-P", os.path.abspath(__file__), "--measure", *groups], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["turn"] = turn
        results.append(result)
        print(f"{turn}: {json.dumps(result)} ({time.perf_counter() - t0:.1f} s with its build)", flush=True)
    for key in ("b2_ms", "b1_ms", "b5a_ms", "b5b_ms", "b5b_rows_ms", "b5b_246_ms", "b5b_246_rows_ms", "b3_ms", "b4_ms", "frame_ms", "b6b_20000_ms",
                "b6b_65536_ms", "b6b_20000_host_us", "b6a_ms", "b7_ms", "ad_step_ms", "ad_bf16_step_ms",
                "ad_step_device_ms"):
        if key in results[0]:
            print(f"  {key}: " + " / ".join(f"{r[key]:.4f}" for r in results))
    for key in ("b6a_b7_spills", "rows_spills"):
        if key in results[0]:
            print(f"  {key} (bytes, registers): " + " / ".join(json.dumps(r[key]) for r in results))
    for passes in ("b2_passes_ms", "b6b_passes_ms"):
        for name in results[0].get(passes, ()):
            print(f"  {passes[:3]} {name}: " + " / ".join(f"{r[passes][name]:.4f}" for r in results))
    for key in ("b3_digest", "b4_digest", "b2_rows_digest", "b5b_digest", "b5b_246_digest", "b6b_20000_digest",
                "b6b_65536_digest"):
        if key in results[0]:
            same = len({r[key] for r in results}) == 1
            print(f"  {key}: {'equal in every turn' if same else 'DIFFERS: ' + str([r[key] for r in results])}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

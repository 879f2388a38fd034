#!/usr/bin/env python3
"""Do ``chip_smoke.py``'s bounds for the rowwise backward kernel (B6b) tell a
wrong kernel from a sound one? On one GPU:

    python -m shapegan_tpu_torch.kernel_mutants

It holds the sound kernel, and the plain version with float64 sums (the
noise floor of bf16 rounding flips), against the float32 plain version at
chip_smoke's B6b cases, then builds each wrong copy of
``ops/csrc/sdf_rowwise_bwd.cu`` in a temporary directory (never in the
checkout) and reports whether it fails the bounds. A wrong kernel that
passes is printed as ``PASSES``.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import sys
import tempfile

import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.ops import _build, sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16

# (what is wrong, source text, its replacement) in sdf_rowwise_bwd.cu.
MUTANTS = (
    ("the layer-1 projection rounded to bf16 before zz1 is added (B2's rounding)",
     "const float2 a = sdf::project_f32(in.pts[r], in.w1p, c);",
     "const float2 a = sdf::project(in.pts[r], in.w1p, c);"),
    ("the layer-5 projection rounded to bf16 before it is added",
     "const float2 p = sdf::project_f32(in.pts[row], in.w5p, col);",
     "const float2 p = sdf::project(in.pts[row], in.w5p, col);"),
    ("the rebuilt layers at the forward's rounding (product rounded before the bias)",
     "v0 = __fadd_rn(v0, __bfloat162float(s.bias[layer * WIDTH + col]));",
     "v0 = __fadd_rn(sdf::round_bf16(v0), __bfloat162float(s.bias[layer * WIDTH + col]));"),
)


def rowwise_backward_float64(pts, w1p, w5p, zz1, zz5, w, b, w8, g):
    """The plain version's math with float64 sums at the same bf16 rounding
    points."""
    f64 = torch.float64
    p = pts.to(BF16).to(f64)
    wf, bf, w8f = w.to(f64), b.to(f64), w8.to(f64)
    h = [torch.relu(p @ w1p.to(f64) + zz1.to(f64)).to(BF16)]
    for layer in range(len(K.TRUNK_KEYS)):
        acc = h[-1].to(f64) @ wf[layer].t()
        acc = acc + p @ w5p.to(f64) + zz5.to(f64) if layer == K.SKIP_LAYER else acc + bf[layer]
        h.append(torch.relu(acc).to(BF16))
    out = torch.tanh(h[-1].to(f64) @ w8f + bf[K.HEAD_BIAS_ROW, 0])
    gz = g.to(f64) * (1 - out * out)
    d_w = torch.zeros(wf.shape, dtype=f64, device=pts.device)
    d_b = torch.zeros((8, K.WIDTH), dtype=f64, device=pts.device)
    dh = gz[:, None] * w8f[None, :]
    for layer in reversed(range(len(K.TRUNK_KEYS))):
        dz = (dh * (h[layer + 1] > 0)).to(BF16).to(f64)
        d_w[layer] = h[layer].to(f64).t() @ dz
        if layer == K.SKIP_LAYER:
            dzz5 = dz
        else:
            d_b[layer] = dz.sum(0)
        dh = dz @ wf[layer]
    outs = (dh * (h[0] > 0), dzz5, d_w, d_b, h[-1].to(f64).t() @ gz, gz.sum().reshape(1))
    return tuple(t.float() for t in outs)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _holds(cs, name, got, want) -> bool:
    try:
        cs.compare_backward(name, got, want, cs.ROWWISE_BWD_NAMES, cs.ROWWISE_PER_ROW)
        return True
    except AssertionError as exc:
        print(f"  outside the bounds: {str(exc)[:160]}")
        return False


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_mutants: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    device = torch.device("cuda", 0)
    bundled = checkpoints.load("sdf_net", base=os.path.join(REPO, "shapegan_tpu", "examples"),
                               device=device)
    random = sdf_mlp.init(torch.Generator().manual_seed(1), device=device)
    cases = {n: cs.rowwise_case(p, n, seed, device)
             for n, p, seed in ((20000, bundled, 6), (3001, random, 7))}
    print(f"== sound kernel, and float64 sums, against the plain version "
          f"({torch.cuda.get_device_name(0)}; {cs.nvidia_smi_line()})")
    sound = True
    for n, (ops, g) in cases.items():
        want = K.rowwise_backward_plain(*ops, g)
        sound &= _holds(cs, f"kernel N={n}", K.rowwise_backward_cuda(*ops, g), want)
        _holds(cs, f"float64 plain N={n}", rowwise_backward_float64(*ops, g), want)

    source = os.path.join(_build.CSRC_DIR, "sdf_rowwise_bwd.cu")
    caught = True
    for what, old, new in MUTANTS:
        with tempfile.TemporaryDirectory() as tmp:
            csrc = os.path.join(tmp, "csrc")
            shutil.copytree(_build.CSRC_DIR, csrc, ignore=shutil.ignore_patterns("build"))
            with open(source) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"mutant {what!r}: its source text is not in {source}")
            with open(os.path.join(csrc, "sdf_rowwise_bwd.cu"), "w") as f:
                f.write(text.replace(old, new))
            saved = _build.CSRC_DIR, _build.BUILD_DIR
            _build.CSRC_DIR, _build.BUILD_DIR = csrc, os.path.join(csrc, "build")
            _build.load.cache_clear()
            try:
                print(f"== wrong kernel: {what}")
                for n, (ops, g) in cases.items():
                    if _holds(cs, f"N={n}", K.rowwise_backward_cuda(*ops, g),
                              K.rowwise_backward_plain(*ops, g)):
                        print(f"  PASSES the bounds at N={n}")
                        caught = False
            finally:
                _build.CSRC_DIR, _build.BUILD_DIR = saved
                _build.load.cache_clear()
    print(f"sound kernel within the bounds: {sound}; every wrong kernel outside them: {caught}")
    return 0 if sound and caught else 1


if __name__ == "__main__":
    sys.exit(main())

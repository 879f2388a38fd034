#!/usr/bin/env python3
"""Do ``chip_smoke.py``'s bounds for the rowwise backward kernel (B6b), the
rowwise forward (B6a), the point-GAN generator kernel (B7), the stash
kernels (B5a, B5b), the points kernel (B3), the trace kernel (B4), the grid
backward's rows pass (B2) and its passes 2-4 tell a wrong kernel from a
sound one? On one GPU:

    python -m shapegan_tpu_torch.kernel_mutants [GROUP ...]

It holds each sound kernel against its plain version at chip_smoke's cases
(for B6b also the plain version with float64 sums, the noise floor of bf16
rounding flips), then builds each wrong copy of ``ops/csrc/sdf_rowwise_bwd.cu``
and of B6b's instance of the rows pass in ``ops/csrc/sdf_grid_bwd_sm90.cuh``,
``ops/csrc/sdf_rowwise.cu`` (B6a), ``ops/csrc/point_gen.cu`` (B7),
``ops/csrc/sdf_grid.cu`` (B1, B5a), ``ops/csrc/sdf_grid_bwd.cu`` (B5b),
``ops/csrc/sdf_trunk_sm90.cuh`` (the trunk of B3 and B4, held at B3's
cases), ``ops/csrc/sdf_trace.cu`` (B4), ``ops/csrc/sdf_grid_bwd_sm90.cuh``
(B2's rows pass, held by its planes at chip_smoke's two cases) and
``ops/csrc/sdf_bwd_passes_sm90.cuh`` (B2's passes 2-4, held by chip_smoke's
passes check) in a temporary directory (never in the checkout) and reports
whether it fails the bounds at every case (B4's mutants: at any of
chip_smoke's three trace cases, since phase 3 runs them all and a wrong lane
update shows only where lanes resolve in its way). A wrong kernel that
passes is printed as ``PASSES``. Name groups (of GROUPS) to run fewer."""

from __future__ import annotations

import contextlib
import importlib.util
import os
import shutil
import sys
import tempfile

import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.ops import _build, sdf_mlp
from shapegan_tpu_torch.ops import point_gen_kernels as PG
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.examples import fit_chair
from shapegan_tpu_torch.ops.coords import voxel_coordinates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16

# (what is wrong, source file in ops/csrc/, source text, its replacement):
# in B6b, its rows pass (the RowInputs instance of sdf_grid_bwd_sm90.cuh) and
# sdf_rowwise_bwd.cu ...
ROWWISE_BWD = "sdf_rowwise_bwd.cu"
ROWS_PASS = "sdf_grid_bwd_sm90.cuh"
_ROUNDED = " for (float2& v : p.v) v = sdf90::unpack_bf16(sdf90::pack_bf16(v.x, v.y));"
ROWWISE_BWD_MUTANTS = (
    ("the layer-1 projection rounded to bf16 before zz1 is added (B2's rounding)", ROWS_PASS,
     "const RowPairs p = in1.point(i, col, a);", "RowPairs p = in1.point(i, col, a);" + _ROUNDED),
    ("the layer-5 projection rounded to bf16 before it is added", ROWS_PASS,
     "p = in5.point(i, col, a);", "p = in5.point(i, col, a);" + _ROUNDED),
    ("the rebuilt layers at the forward's rounding (product rounded before the bias)", ROWS_PASS,
     "float v0 = d[4 * i + 2 * hh], v1 = d[4 * i + 2 * hh + 1];",
     "float v0 = sdf90::round_bf16(d[4 * i + 2 * hh]), v1 = sdf90::round_bf16(d[4 * i + 2 * hh + 1]);"),
    ("zz1 read from the row 8 below", ROWS_PASS,
     "sdf90::load_tile(a, zz1, r.row, r);", "Rows o = r; o.count -= 8; sdf90::load_tile(a, zz1, r.row + 8, o);"),
    ("zz5 read from the row 8 below", ROWS_PASS,
     "if (skip) sdf90::load_tile(a, zz5, r.row, r);",
     "if (skip) { Rows o = r; o.count -= 8; sdf90::load_tile(a, zz5, r.row + 8, o); }"),
    ("dz5, and with it dzz5, taken before its mask", ROWS_PASS,
     "load_bits(s, L, bits);", "load_bits(s, L, bits); if (L == 4) for (uint32_t& b : bits) b = ~0u;"),
    ("dzz5 widened from the dz plane one layer early (dz6's)", ROWWISE_BWD,
     "tail_kernel<<<blocks, WIDTH, 0, stream>>>(dz + SKIP_LAYER * plane,",
     "tail_kernel<<<blocks, WIDTH, 0, stream>>>(dz + (SKIP_LAYER + 1) * plane,"),
    ("d_w8 and d_b8 summed over one row fewer a block", ROWWISE_BWD,
     "for (int k = 0; k < count; ++k) {", "for (int k = 0; k < count - 1; ++k) {"),
)
# ... in point_gen.cu ...
POINT_GEN = "point_gen.cu"
POINT_GEN_MUTANTS = (
    ("the pre-LayerNorm sum rounded to bf16 (flax's rounding point)", POINT_GEN,
     "      d[4 * j + 2 * h] = v0;\n",
     "      v0 = sdf90::round_bf16(v0);\n      v1 = sdf90::round_bf16(v1);\n      d[4 * j + 2 * h] = v0;\n"),
    ("every row reading item 0's zz rows", POINT_GEN,
     "static_cast<size_t>(min(r.row[h] / g.n, g.batch - 1LL))", "size_t{0}"),
    ("the variance taken without subtracting the mean", POINT_GEN,
     "const float dev = d[4 * j + 2 * h + e] - mean[h];", "const float dev = d[4 * j + 2 * h + e];"),
    ("the LayerNorm and head sums over two lanes of the quad (the second shuffle dropped)", POINT_GEN,
     "  v += __shfl_xor_sync(0xffffffffu, v, 2);\n", ""),
)
# ... in sdf_rowwise.cu (B6a) ...
ROWWISE = "sdf_rowwise.cu"
ROWWISE_MUTANTS = (
    ("zz1 read from the row 8 below", ROWWISE,
     "sdf90::load_tile(a, g.zz1, r.row, r);", "Rows o = r; o.count -= 8; sdf90::load_tile(a, g.zz1, r.row + 8, o);"),
    ("pp5 not rounded to bf16 before it is added", ROWWISE,
     "return sdf90::project(h ? p1 : p0, s.w5p, c);",
     "return sdf90::project_f32(h ? p1 : p0, sdf90::pair(s.w5p[0], c), sdf90::pair(s.w5p[1], c), "
     "sdf90::pair(s.w5p[2], c));"),
    ("zz5 added before pp5", ROWWISE,
     "sdf90::trunk_epilogue<sdf90::kSkip>(d, a, sdf90::RegisterPair{a}, pp5,",
     "sdf90::trunk_epilogue<sdf90::kSkip>(d, a, pp5, sdf90::RegisterPair{a},"),
)

# ... in the wgmma trunk (sdf_trunk_sm90.cuh: the products and the forward
# epilogue of B1, B5a, B3 and B4, and the products of B2's rows pass) ...
TRUNK = "sdf_trunk_sm90.cuh"
DESCRIPTOR_MUTANT = ("each slice's K-blocks read in the wrong order (a K-slice descriptor offset wrong)", TRUNK,
                     "desc + 2 * kk, kc | kk)", "desc + 2 * (kk ^ 1), kc | kk)")
LATE_ROUND_MUTANT = ("the product rounded after the bias, not before (_bwd_kernel's rounding)", TRUNK,
                     "float2 v = unpack_bf16(pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));",
                     "float2 v = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);")
# ... checked at B3's cases ...
TRUNK_SM90_MUTANTS = (DESCRIPTOR_MUTANT, LATE_ROUND_MUTANT)
# ... in sdf_grid.cu (B1 and its stash instance B5a), checked at phase 3's
# B1 cases (B1 and B5a at each) ...
GRID = "sdf_grid.cu"
GRID_MUTANTS = (
    LATE_ROUND_MUTANT,
    ("pp5 read one point tile off (the next tile of the same shape)", GRID,
     "sdf90::load_tile(a, g.pp5, r.point, r);",
     "const Rows o = sdf90::rows_of((r.point - r.r0) / ROWS * static_cast<long long>(g.shapes) + g.shapes"
     " + r.shape, g.shapes, g.points, g.tiles); sdf90::load_tile(a, g.pp5, o.point, o);"),
    DESCRIPTOR_MUTANT,
    ("each stash plane written one layer late", GRID,
     "return kept<kStash>(c, r, a, g.plane[L + 1]);", "return kept<kStash>(c, r, a, g.plane[L]);"),
)
# ... and at the B1 cases of more than one shape (with one shape the next
# shape is the shape itself, and this kernel the sound one).
GRID_SHAPES_MUTANTS = (
    ("zz5 of the next shape", GRID,
     "const bf16* z5 = g.zz5 + static_cast<size_t>(r.shape) * WIDTH;",
     "const bf16* z5 = g.zz5 + static_cast<size_t>((r.shape + 1) % g.shapes) * WIDTH;"),
)
# ... in sdf_grid_bwd.cu (the stash backward's part): checked at every case ...
GRID_BWD = "sdf_grid_bwd.cu"
STASH_BWD_MUTANTS = (
    ("the stashed positions rebuilt at B2's rounding points (nothing read from the stash)", GRID_BWD,
     "plan.stashed = mask & 0x7eu;", "plan.stashed = 0u;"),
)
# ... and at the cases of more than one chunk (16 x 64^3: sixteen; the odd
# case is one chunk, where this kernel is the sound one).
STASH_BWD_CHUNK_MUTANTS = (
    ("every chunk reading the stashed planes of the batch's first shapes", GRID_BWD,
     "static_cast<bf*>(stash[j]) + static_cast<size_t>(s0) * pw", "static_cast<bf*>(stash[j])"),
)
# ... in sdf_trace.cu (B4's lane update and refill), at its cases.
TRACE = "sdf_trace.cu"
TRACE_MUTANTS = (
    ("the trace advance as an FMA", TRACE,
     """  const float x = __fadd_rn(sl.pos[0], __fmul_rn(sl.dir[0], d));
  const float y = __fadd_rn(sl.pos[1], __fmul_rn(sl.dir[1], d));
  const float z = __fadd_rn(sl.pos[2], __fmul_rn(sl.dir[2], d));""",
     """  const float x = fmaf(sl.dir[0], d, sl.pos[0]);
  const float y = fmaf(sl.dir[1], d, sl.pos[1]);
  const float z = fmaf(sl.dir[2], d, sl.pos[2]);"""),
    ("a refilled slot keeping the previous lane's step count", TRACE,
     "    slot.steps = 0;\n", ""),
)

# ... and in sdf_grid_bwd_sm90.cuh (B2's rows pass), held by its planes.
ROWS_MUTANTS = (
    ("the rebuilt layers at B3's rounding (the product rounded before the bias)", ROWS_PASS,
     "float v0 = d[4 * i + 2 * hh], v1 = d[4 * i + 2 * hh + 1];",
     "float v0 = sdf90::round_bf16(d[4 * i + 2 * hh]), v1 = sdf90::round_bf16(d[4 * i + 2 * hh + 1]);"),
    ("the backward mask taken from the layer's output instead of its input", ROWS_PASS,
     "load_bits(s, L, bits);", "load_bits(s, L < LAYERS - 1 ? L + 1 : L, bits);"),
    ("the backward's K-blocks at the wrong offset (the wt slices' K coordinate swapped in pairs)", ROWS_PASS,
     "+ back % CHUNKS_PER_LAYER;", "+ (back % CHUNKS_PER_LAYER ^ 1);"),
    DESCRIPTOR_MUTANT,
)

# ... and in sdf_bwd_passes_sm90.cuh (B2's passes 2-4, shared with B5b),
# held by chip_smoke's passes check at its two cases (16 one-shape chunks of
# 64^3; B=3, P=3001 as one chunk and from s0 = 1) ...
PASSES = "sdf_bwd_passes_sm90.cuh"
PASSES_MUTANTS = (
    ("d_b taken from the next layer's dz (the column sums kept in the next layer's slot)", PASSES,
     "(static_cast<size_t>(it.layer * SLABS + it.slab) * CONSUMERS + wg)",
     "(static_cast<size_t>((it.layer + 1) % LAYERS * SLABS + it.slab) * CONSUMERS + wg)"),
    ("d_pp5 summed over one shape fewer", PASSES,
     "      add4(pp5[i], d5);\n", "      if (s + 1 < a.shapes) add4(pp5[i], d5);\n"),
    ("an h tile one row tile off its dz tile", PASSES,
     "HALF * it.half + BOX_COLS * c, row, bar);", "HALF * it.half + BOX_COLS * c, row + KT, bar);"),
    ("the MN-major descriptors' LBO and SBO swapped", PASSES,
     "(static_cast<uint64_t>(BOX_BYTES >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32)",
     "(static_cast<uint64_t>(1024 >> 4) << 16) | (static_cast<uint64_t>(BOX_BYTES >> 4) << 32)"),
)
# ... and at the case whose chunks end in a part tile (P = 3001; 64^3 chunks
# are whole tiles, where this kernel is the sound one).
PASSES_TAIL_MUTANTS = (
    ("tail rows not zero-filled (the tensor maps' rows rounded up to whole tiles)", PASSES,
     "const cuuint64_t dims[2] = {WIDTH, static_cast<cuuint64_t>(rows)};",
     "const cuuint64_t dims[2] = {WIDTH, static_cast<cuuint64_t>((rows + KT - 1) / KT * KT)};"),
)

# Every wrong kernel above (the CPU tests check that each one's source text
# occurs exactly once in its file, so that none is a no-op).
ALL_MUTANTS = tuple(dict.fromkeys(
    ROWWISE_BWD_MUTANTS + POINT_GEN_MUTANTS + ROWWISE_MUTANTS + TRUNK_SM90_MUTANTS + GRID_MUTANTS + GRID_SHAPES_MUTANTS
    + STASH_BWD_MUTANTS + STASH_BWD_CHUNK_MUTANTS + TRACE_MUTANTS + ROWS_MUTANTS + PASSES_MUTANTS
    + PASSES_TAIL_MUTANTS))


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


def _holds(check) -> bool:
    try:
        check()
        return True
    except AssertionError as exc:
        print(f"  outside the bounds: {str(exc)[:160]}")
        return False


def _rowwise_bwd_check(cs, cases, n, kernel=None):
    ops, g = cases[n]
    want = K.rowwise_backward_plain(*ops, g)
    got = (kernel or K.rowwise_backward_cuda)(*ops, g)
    return lambda: cs.compare_backward(f"rowwise_bwd N={n}", got, want, cs.ROWWISE_BWD_NAMES,
                                       cs.ROWWISE_PER_ROW)


def _rowwise_check(cs, cases, n):
    ops = cases[n][0]
    got, want = K.rowwise_forward_cuda(*ops), K.rowwise_forward_plain(*ops)
    return lambda: cs.compare(f"rowwise N={n}", got, want)


def _point_gen_check(cs, cases, shape):
    ops = cases[shape][0]
    got, want = PG.generate_cuda(*ops), PG.generate_plain(*ops)
    return lambda: cs.compare(f"point_gen B={shape[0]} N={shape[1]}", got, want, cs.GEN_MAX_ABS,
                              cs.GEN_MEAN_ABS)


def _stash_fwd_check(cs, cases, key):
    name, stash = key
    ops = cases[name][0]
    b1 = K.grid_forward_cuda(*ops)
    got, want = K.grid_forward_stash_cuda(*ops, stash), K.grid_forward_stash_plain(*ops, stash)
    return lambda: cs.compare_stash_forward(f"grid_stash {name} {stash}", got, want, b1, stash)


def _stash_bwd_check(cs, cases, key, sound):
    """B5b on the sound B5a's planes against the plain version's outputs
    (``sound``: key -> (planes, plain outputs), made once)."""
    name, stash = key
    ops, g = cases[name]
    planes, want = sound[key]
    got = K.grid_backward_stash_cuda(*ops, g, planes, stash)
    return lambda: cs.compare_backward(f"grid_stash_bwd {name} {stash}", got, want)


def _points_check(cs, cases, name):
    ops = cases[name]
    got, want = K.points_forward_cuda(*ops), K.points_forward_plain(*ops)
    return lambda: cs.compare(f"points {name}", got, want)


def _rows_check(cs, case):
    ops, g = case
    return lambda: cs.rows_checks(ops, g)


def _trace_check(cs, case, weights):
    name, pts, dirs, status, escape, kw = case
    ops = (pts, dirs, status, escape) + weights
    got, want = K.trace_steps_cuda(*ops, **kw), K.trace_steps_plain(*ops, **kw)
    return lambda: cs.compare_trace(name, got, want, (pts, status))


@contextlib.contextmanager
def built_with(edits):
    """The kernels built from a copy of ``ops/csrc/`` in a temporary
    directory with ``edits`` ((file, source text, replacement), ...)
    applied, loaded in place of the checkout's while the block runs."""
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(_build.CSRC_DIR, csrc, ignore=shutil.ignore_patterns("build"))
        for name, old, new in edits:
            path = os.path.join(csrc, name)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"{old!r} is not in {name}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        saved = _build.CSRC_DIR, _build.BUILD_DIR
        _build.CSRC_DIR, _build.BUILD_DIR = csrc, os.path.join(csrc, "build")
        _build.load.cache_clear()
        try:
            yield
        finally:
            _build.CSRC_DIR, _build.BUILD_DIR = saved
            _build.load.cache_clear()


def _wrong_kernels(mutants, checks, every=True) -> bool:
    """Build each mutant (what, file, text, replacement) of ``ops/csrc/`` in
    a temporary directory and run ``checks`` (case → a check, made after the
    build) against it; True if every mutant fails at every case (``every``)
    or at one case at least."""
    caught = True
    for what, name, old, new in mutants:
        with built_with([(name, old, new)]):
            print(f"== wrong kernel ({name}): {what}", flush=True)
            held = [case for case, check in checks.items() if _holds(check())]
            if held:
                print(f"  holds the bounds at {held}")
            if held and (every or len(held) == len(checks)):
                print("  PASSES")
                caught = False
    return caught


GROUPS = ("grid", "rows", "passes", "rowwise_bwd", "rowwise", "point_gen", "stash", "trunk", "trace")


def main(argv=()) -> int:
    """Runs the groups named in ``argv`` (of GROUPS), or all of them."""
    if not torch.cuda.is_available():
        print("kernel_mutants: CUDA is not available", file=sys.stderr)
        return 1
    groups = [g for g in GROUPS if g in argv] or list(GROUPS)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    device = torch.device("cuda", 0)
    bundled = checkpoints.load("sdf_net", base=os.path.join(REPO, "shapegan_tpu", "examples"),
                               device=device)
    random = sdf_mlp.init(torch.Generator().manual_seed(1), device=device)
    grid64 = voxel_coordinates(64, device=device)
    odd = (torch.rand(3001, 3, generator=torch.Generator().manual_seed(0)) * 2.2 - 1.1).to(device)
    print(f"== groups {groups} ({torch.cuda.get_device_name(0)}; {cs.nvidia_smi_line()})", flush=True)
    sound = caught = True

    if "grid" in groups:
        # B1 and B5a at phase 3's four cases (the bundled codes as chip_smoke's).
        latents16 = cs.path_latents(device)[1]
        grid_cases = cs.grid_cases(bundled, random, latents16, grid64, odd, device)
        checks = {name: (lambda name=name: lambda: cs.grid_check(name, grid_cases[name])) for name in grid_cases}
        print("== B1 and B5a against their plain versions", flush=True)
        sound &= all([_holds(check()) for check in checks.values()])
        caught &= _wrong_kernels(GRID_MUTANTS, checks)
        caught &= _wrong_kernels(GRID_SHAPES_MUTANTS,
                                 {name: check for name, check in checks.items() if not name.startswith("B=1 ")})
    if "rows" in groups:
        rows_cases = {"B=16 P=64^3": cs.stash_case(bundled, grid64, 16, 15, device),
                      "B=3 P=3001": cs.stash_case(random, odd, 3, 16, device)}
        print("== B2's rows pass against its plain version", flush=True)
        sound &= all([_holds(_rows_check(cs, case)) for case in rows_cases.values()])
        caught &= _wrong_kernels(ROWS_MUTANTS, {name: (lambda case=case: _rows_check(cs, case))
                                                for name, case in rows_cases.items()})
    if "passes" in groups:
        passes_cases = {"B=16 P=64^3": cs.stash_case(bundled, grid64, 16, 15, device),
                        "B=3 P=3001": cs.stash_case(random, odd, 3, 16, device)}
        checks = {name: (lambda case=case: (lambda: cs.passes_checks(*case))) for name, case in passes_cases.items()}
        print("== B2's passes 2-4 against their plain version", flush=True)
        sound &= all([_holds(check()) for check in checks.values()])
        caught &= _wrong_kernels(PASSES_MUTANTS, checks)
        caught &= _wrong_kernels(PASSES_TAIL_MUTANTS, {"B=3 P=3001": checks["B=3 P=3001"]})
    if "rowwise_bwd" in groups:
        cases = {n: cs.rowwise_case(p, n, seed, device)
                 for n, p, seed in ((20000, bundled, 6), (3001, random, 7))}
        print("== B6b, and float64 sums, against the plain version", flush=True)
        for n in cases:
            sound &= _holds(_rowwise_bwd_check(cs, cases, n))
            _holds(_rowwise_bwd_check(cs, cases, n, kernel=rowwise_backward_float64))
        caught &= _wrong_kernels(ROWWISE_BWD_MUTANTS,
                                 {n: (lambda n=n: _rowwise_bwd_check(cs, cases, n)) for n in cases})
    if "rowwise" in groups:
        cases = {n: cs.rowwise_case(p, n, seed, device) for n, p, seed in ((20000, bundled, 6), (3001, random, 7))}
        print("== B6a against its plain version", flush=True)
        for n in cases:
            sound &= _holds(_rowwise_check(cs, cases, n))
        caught &= _wrong_kernels(ROWWISE_MUTANTS, {n: (lambda n=n: _rowwise_check(cs, cases, n)) for n in cases})
    if "point_gen" in groups:
        gen_cases = {(b, n): cs.point_gen_case(b, n, seed, device)
                     for b, n, seed in ((32, 4096, 10), (3, 1000, 11), (2, 100, 13))}
        print("== B7 against its plain version", flush=True)
        for shape in gen_cases:
            sound &= _holds(_point_gen_check(cs, gen_cases, shape))
        caught &= _wrong_kernels(POINT_GEN_MUTANTS, {shape: (lambda shape=shape: _point_gen_check(cs, gen_cases, shape))
                                                     for shape in gen_cases})
    if "stash" in groups:
        stash_cases = {"B=16 P=64^3": cs.stash_case(random, grid64, 16, 13, device),
                       "B=3 P=3001": cs.stash_case(random, odd, 3, 14, device)}
        stash_keys = [(name, stash) for name in stash_cases for stash in cs.STASH_SETS]
        sound_stash = {}
        for name, stash in stash_keys:
            ops, g = stash_cases[name]
            planes = K.grid_forward_stash_cuda(*ops, stash)[1]
            sound_stash[(name, stash)] = planes, K.grid_backward_stash_plain(*ops, g, planes, stash)
        print("== B5a and B5b against their plain versions", flush=True)
        for key in stash_keys:
            sound &= _holds(_stash_fwd_check(cs, stash_cases, key))
            sound &= _holds(_stash_bwd_check(cs, stash_cases, key, sound_stash))
        checks = {key: (lambda key=key: _stash_bwd_check(cs, stash_cases, key, sound_stash)) for key in stash_keys}
        caught &= _wrong_kernels(STASH_BWD_MUTANTS, checks)
        caught &= _wrong_kernels(STASH_BWD_CHUNK_MUTANTS,
                                 {key: check for key, check in checks.items() if key[0] == "B=16 P=64^3"})
    if "trunk" in groups:
        # B3 at chip_smoke's two shapes (zero latents).
        folded = sdf_mlp.fold_latent(bundled, torch.zeros(128, device=device))
        points_cases = {"N=128^3 L=0": K.points_operands(folded, voxel_coordinates(128, device=device),
                                                         torch.zeros(0, device=device)),
                        "N=3001 L=128": K.points_operands(bundled, odd, torch.zeros(128, device=device))}
        print("== B3 against its plain version", flush=True)
        for name in points_cases:
            sound &= _holds(_points_check(cs, points_cases, name))
        caught &= _wrong_kernels(TRUNK_SM90_MUTANTS, {name: (lambda name=name: _points_check(cs, points_cases, name))
                                                      for name in points_cases})
    if "trace" in groups:
        # B4 at chip_smoke's three trace cases, on the chair fitted here.
        chair, chair_code = fit_chair(device)
        chair_folded = sdf_mlp.fold_latent(chair, chair_code)
        chair_weights = K.point_weights(chair_folded, chair_code[:0])
        trace_cases = cs.trace_cases(chair_folded, device)
        print("== B4 against its plain version", flush=True)
        for case in trace_cases:
            sound &= _holds(_trace_check(cs, case, chair_weights))
        caught &= _wrong_kernels(
            TRACE_MUTANTS,
            {case[0]: (lambda case=case: _trace_check(cs, case, chair_weights)) for case in trace_cases},
            every=False)
    print(f"sound kernels within the bounds: {sound}; every wrong kernel outside them: {caught}")
    return 0 if sound and caught else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""The design choices of the wgmma trunk (``ops/csrc/sdf_trunk_sm90.cuh``),
of the point-GAN generator B7 on it (``ops/csrc/point_gen.cu``),
of the grid forward B1 and its stash instance B5a (``ops/csrc/sdf_grid.cu``)
of the grid backward's Hopper rows pass (``ops/csrc/sdf_grid_bwd_sm90.cuh``,
also B5b's placement of its stash loads)
and of its passes 2-4 (``ops/csrc/sdf_bwd_passes_sm90.cuh``), and of the
rowwise backward B6b on them (``ops/csrc/sdf_rowwise_bwd.cu``), timed
against the shipped kernels. On one GPU:

    python -m shapegan_tpu_torch.kernel_variants [trunk | rows | grid | passes | rowwise | point_gen | stash]

Each variant is the shipped source with one choice undone, built in a
temporary directory (never in the checkout) as ``kernel_mutants`` builds
its wrong kernels, and timed in turns with the shipped build (shipped,
variant, variant, shipped; CUDA events, medians): B3 at 128^3 and B4 on the
chair's 1600^2 primary rays x k=20, chip_smoke's main-path shapes. A
variant that changes the results is timed on B3 only (B4's work would
change with them) and says so. The rows-pass variants are timed by B2's
rows pass at 16 x 64^3 (bundled weights, sixteen one-shape calls of
``grid_backward_rows_cuda``), whatever they do to the results; the grid
variants by B1 and B5a (stash set (1..6)) at 16 x 64^3 (bundled weights);
the passes variants by B2 at 16 x 64^3 and the passes alone over sixteen
one-shape chunks (one shape's planes), beside ``torch.bmm`` of the weight
products as a yardstick; the rowwise variants by B6b at 20,000 rows (one
call, and ten back to back), after B6b's passes (``torch.profiler`` device
time) at one, about one and a fifth, and two rounds of 64-row tiles; the
point_gen variants by B7 at 32 x 4096 and 6 x 32768 and B6a at 20,000 and
65,536 rows (a call's share of ten back to back), after a tile's SM cycles
and nanoseconds in B7 (clock64 and globaltimer in an instrumented build);
the stash variants by the stash backward B5b at 16 x 64^3 at chip_smoke's
STASH_SETS, one call and its rows pass's device time.
With an argument only that group runs.
"""

from __future__ import annotations

import os
import re
import sys

import torch

from shapegan_tpu_torch.examples import fit_chair
from shapegan_tpu_torch.kernel_mutants import _chip_smoke, built_with
from shapegan_tpu_torch.ops import _build, sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.ops.coords import voxel_coordinates

TRUNK = "sdf_trunk_sm90.cuh"
_STALE_WEIGHTS = (TRUNK, """    bar_expect(&s.full[pos.stage], SLICE_BYTES);
    load_slice(s.ring[pos.stage], map, chunk, &s.full[pos.stage]);""",
                  """    if (issued < N) {
      bar_expect(&s.full[pos.stage], SLICE_BYTES);
      load_slice(s.ring[pos.stage], map, chunk, &s.full[pos.stage]);
    } else {
      bar_expect(&s.full[pos.stage], 0);
    }""")
_NO_TURNS = [(TRUNK, "  named_sync(TURN_BARRIER + wg, 128 * CONSUMERS);\n", ""),
             (TRUNK, "  named_arrive(TURN_BARRIER + (1 - wg), 128 * CONSUMERS);  // the other consumer's turn\n", "")]
# (name, edits, whether the results stay the kernel's)
VARIANTS = (
    ("no ping-pong (the consumers issue their products when they like)",
     _NO_TURNS, True),
    ("a 4-stage ring", [(TRUNK, "constexpr int STAGES = 6;", "constexpr int STAGES = 4;")], True),
    ("no weight traffic after the ring's first fill (stale weights: the L2 traffic's cost)",
     [_STALE_WEIGHTS], False),
)

GRID = "sdf_grid.cu"
# (name, edits): B1's and B5a's design choices.
GRID_VARIANTS = (
    ("B1 on a 4-stage ring (B5a's)",
     [(GRID, "constexpr int RING_STAGES = kStash ? SLOTS - CONSUMERS : SLOTS;",
       "constexpr int RING_STAGES = SLOTS - CONSUMERS;")]),
    ("pp5 prefetched into L2 at the tile's start (the skip epilogue's loads hit L2)",
     [(GRID, "  sdf90::load_tile(a, g.pp1, r.point, r);\n",
       "  sdf90::load_tile(a, g.pp1, r.point, r);\n"
       "  for (int hh = 0; hh < 2; ++hh)\n"
       "    if (r.ok(hh)) asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(sdf90::at(g.pp5, r.point, hh) "
       "+ 62 * (threadIdx.x & 3)));\n")]),
    ("no ping-pong (the consumers issue their products when they like)", _NO_TURNS),
    ("no weight traffic after the ring's first fill (stale weights: the L2 traffic's cost)",
     [_STALE_WEIGHTS]),
)

ROWS = "sdf_grid_bwd_sm90.cuh"
STAGED = "sdf_rows_sm90.cuh"  # the predicated and staged stores, shared with B5a
# (name, edits): each a diagnosis of where the rows pass's time goes.
_NO_DX1 = (STAGED, "void store_f32x2(float* p, float x, float y, bool ok) {",
           "void store_f32x2(float* p, float x, float y, bool ok) { return;")
ROWS_VARIANTS = (
    ("no stores of h, dz and dx1 (the staging kept)",
     [(STAGED, "@p st.global.v4.b32 [%0], {%1, %2, %3, %4};", ""), _NO_DX1]),
    ("no dx1 stores", [_NO_DX1]),
    ("dz2..dz6 not stored (5 of the 13 bf16 planes)",
     [(ROWS, "return L > 0 ? stage(c, r, a, g.dz + (L - 1) * g.plane) : Pending{nullptr, 0};",
       "return Pending{nullptr, 0};")]),
    ("streaming stores (st.global.cs: evict first)",
     [(STAGED, "@p st.global.v4.b32 [%0]", "@p st.global.cs.v4.b32 [%0]"),
      (STAGED, "@p st.global.v2.f32 [%0]", "@p st.global.cs.v2.f32 [%0]")]),
    ("no weight traffic after the ring's first fill (stale weights: the L2 traffic's cost)",
     [(ROWS, """    sdf90::bar_expect(&s.full[pos.stage], sdf90::SLICE_BYTES);
    sdf90::load_slice(s.ring[pos.stage], back < 0 ? wmap : wtmap, chunk, &s.full[pos.stage]);""",
       """    if (issued < STAGES) {
      sdf90::bar_expect(&s.full[pos.stage], sdf90::SLICE_BYTES);
      sdf90::load_slice(s.ring[pos.stage], back < 0 ? wmap : wtmap, chunk, &s.full[pos.stage]);
    } else {
      sdf90::bar_expect(&s.full[pos.stage], 0);
    }""")]),
)


# (name, edits): where B5b's rows pass (the StashInputs instances) reads a
# stashed position's mask. Shipped (mask_from_plane): from the tile the
# forward reads as the next layer's operand, else, where the next position
# is stashed too and the forward reads no tile, from its plane in the
# backward epilogue that masks by it. The first two variants take one of
# the two everywhere; the third makes the backward's choice when compiled;
# the fourth runs the full plan on the instance that reads its plan at run
# time.
_MASK_RULE = "  return (stashed >> j) & (stashed >> (j + 1)) & 1u;\n"
STASH_VARIANTS = (
    ("every stashed tile read in the forward and its bits kept (no mask read from a plane)",
     [(ROWS, _MASK_RULE, "  return false;\n")]),
    ("every stashed mask read from its plane in the backward epilogue (a tile read in the forward only for "
     "the next layer), as the mma.sync kernel did",
     [(ROWS, _MASK_RULE, "  return (stashed >> j) & 1u;\n")]),
    ("the backward's choice made when compiled in the full instance (the plan's constant bits)",
     [(ROWS, "mask_from_plane(g.in.plan.stashed, L)", "mask_from_plane(In::full ? FULL_PLAN : g.in.plan.stashed, L)")]),
    ("no instance for the full plan (every plan read at run time, the wgmmas serialized)",
     [("sdf_grid_bwd.cu",
       "  if (plan->stashed == sdf90_bwd::FULL_PLAN) return stash(sdf90_bwd::Args<StashInputs<true>>{{in}});\n", "")]),
)

# (name, edits): where B6b's rows pass (the RowInputs instance) spends its time.
ROWWISE_VARIANTS = (
    ("no projections (the point terms zero: no w1p / w5p loads, no FMAs)",
     [(ROWS, "return {{sdf90::project_f32(p[0], w0, w1, w2), sdf90::project_f32(p[1], w0, w1, w2)}};",
       "return {};")]),
    ("no stores of h, dz and dzz1 (the staging kept)",
     [(STAGED, "@p st.global.v4.b32 [%0], {%1, %2, %3, %4};", ""), _NO_DX1]),
    ROWS_VARIANTS[-1],
)


POINT_GEN = "point_gen.cu"
ROWWISE_FWD = "sdf_rowwise.cu"
# (name, edits): the design choices of B7 (and the producer of B6a), and two
# diagnoses of its LayerNorm epilogue (results wrong).
POINT_GEN_VARIANTS = (
    ("generic loads of the epilogue's shared-memory operands (sdf90::pair), not ld.shared",
     [(POINT_GEN, "smem_pair(s.", "sdf90::pair(s."), (POINT_GEN, "smem_pair(wp[", "sdf90::pair(wp[")]),
    ("the producer stopped by the consumers' flag (sdf90::produce), not by its slice count (B7 and B6a)",
     [(POINT_GEN, "sdf90::produce_slices<STAGES>(s, &wmap, sdf90::block_rounds(args.tiles) * sdf90::CHUNKS);",
       "sdf90::produce<STAGES>(s, &wmap);"),
      (ROWWISE_FWD, "sdf90::produce_slices(s, &wmap, sdf90::block_rounds(args.tiles) * sdf90::CHUNKS);",
       "sdf90::produce(s, &wmap);")]),
    ("no LayerNorm reductions (mean 0, variance 1: their cost; results wrong)",
     [(POINT_GEN, "mean[h] = quad_sum(sum[h]) * INV_WIDTH;", "mean[h] = 0.f;"),
      (POINT_GEN, "inv[h] = rsqrtf(quad_sum(sq[h]) * INV_WIDTH + LN_EPS);", "inv[h] = 1.f;")]),
    ("no affine map in the normalization (y = x: its cost; results wrong)",
     [(POINT_GEN, "const float y0 = fmaf((d[4 * j + 2 * h] - mean[h]) * inv[h], gm.x, bt.x);",
       "const float y0 = d[4 * j + 2 * h] + 0.f * inv[h];"),
      (POINT_GEN, "const float y1 = fmaf((d[4 * j + 2 * h + 1] - mean[h]) * inv[h], gm.y, bt.y);",
       "const float y1 = d[4 * j + 2 * h + 1] + 0.f * inv[h];")]),
)
# A tile's SM cycles (clock64) and nanoseconds (globaltimer), from the start
# of B7's tile to its last epilogue, stored in place of its two rows' outputs.
_TILE_CLOCK = [
    (POINT_GEN, "  const TileRows r = tile_rows(g, t);\n",
     "  long long c0 = clock64(), n0;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(n0));\n"
     "  const TileRows r = tile_rows(g, t);\n"),
    (POINT_GEN, "  const int q = threadIdx.x & 3;\n  sdf90::store_f32(g.out + r.row[0], v.x,",
     "  long long c1 = clock64(), n1;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(n1));\n"
     "  const int q = threadIdx.x & 3;\n  sdf90::store_f32(g.out + r.row[0], static_cast<float>(c1 - c0) + 0.f * v.x,"),
    (POINT_GEN, "sdf90::store_f32(g.out + r.row[1], v.y,",
     "sdf90::store_f32(g.out + r.row[1], static_cast<float>(n1 - n0) + 0.f * v.y,"),
]


def point_gen_variants(cs, device) -> None:
    from shapegan_tpu_torch import checkpoints
    from shapegan_tpu_torch.ops import point_gen_kernels as PG

    gen = {(b, n): cs.point_gen_case(b, n, seed, device)[0] for b, n, seed in ((32, 4096, 10), (6, 32768, 12))}
    params = checkpoints.load("sdf_net", base=os.path.join(cs.REPO, "shapegan_tpu", "examples"), device=device)
    rows = {n: cs.rowwise_case(params, n, 6, device)[0] for n in (20000, 65536)}

    def ten(fn):  # a call's share of ten back to back: the device's time once the host runs ahead
        return cs.time_ms(lambda: [fn() for _ in range(10)], iters=10) / 10

    def times():
        with torch.no_grad():
            out = [ten(lambda ops=ops: PG.generate_cuda(*ops)) for ops in gen.values()]
        return out + [ten(lambda ops=ops: K.rowwise_forward_cuda(*ops)) for ops in rows.values()]

    with built_with(_TILE_CLOCK):
        for (b, n), ops in gen.items():
            out = PG.generate_cuda(*ops).reshape(-1).double()
            torch.cuda.synchronize()
            idx = torch.arange(out.numel(), device=device)
            cycles, ns = out[(idx % 16) < 8], out[(idx % 16) >= 8]
            print(f"== B7 {b} x {n}: a tile {float(cycles.median()):.0f} SM cycles in {float(ns.median()):.0f} ns "
                  f"(median over tiles): {float(cycles.sum() / ns.sum()):.3f} GHz", flush=True)
    for name, edits in POINT_GEN_VARIANTS:
        print(f"== point_gen: {name}", flush=True)
        readings = [("shipped", *times())]
        with built_with(edits):
            readings += [("variant", *times()) for _ in range(2)]
        readings.append(("shipped", *times()))
        for turn, b7, b7_big, b6a, b6a_big in readings:
            print(f"  {turn}: a call of ten back to back: B7 32 x 4096 {b7:.4f} ms, 6 x 32768 {b7_big:.4f} ms; "
                  f"B6a 20,000 rows {b6a:.4f} ms, 65,536 {b6a_big:.4f} ms", flush=True)


def rows_spills() -> dict:
    """The rows pass's instances in the current build's ptxas output (-v):
    {instance: (bytes of spill stores a thread, registers)}."""
    instances = {"RowInputs": "RowInputs", "StashInputsILb1": "StashInputs<true>",
                 "StashInputsILb0": "StashInputs<false>", "GridInputs": "GridInputs"}
    lines = _build.build_log().splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*bwd_rows_sm90_kernel\S*)'", line)
        if m:
            text = " ".join(lines[i + 1:i + 4])
            spill, regs = re.search(r"(\d+) bytes spill stores", text), re.search(r"Used (\d+) registers", text)
            out[next(name for key, name in instances.items() if key in m.group(1))] = (
                int(spill.group(1)) if spill else None, int(regs.group(1)) if regs else None)
    return out


def rowwise_variants(cs, device) -> None:
    gen_params = sdf_mlp.init(torch.Generator().manual_seed(1), device=device)
    cases = {n: cs.rowwise_case(gen_params, n, 6, device) for n in (264 * 64, 20000, 2 * 264 * 64)}

    def b6b(n):
        ops, g = cases[n]
        return lambda: K.rowwise_backward_cuda(*ops, g)

    for n in cases:
        split = cs.rowwise_bwd_split(b6b(n))
        print(f"== B6b at {n} rows ({-(-n // 64)} tiles for 264 consumers): {cs.time_ms(b6b(n), iters=20):.4f} "
              f"ms; device time by pass " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    def times():
        # One call (CUDA events; its host work before the first launch
        # included), a call's share of ten back to back (the device's), and
        # the rows pass's device time and spills.
        one = cs.time_ms(b6b(20000), iters=20)
        queued = cs.time_ms(lambda: [b6b(20000)() for _ in range(10)], iters=10) / 10
        return one, queued, cs.rowwise_bwd_split(b6b(20000))["rows"], rows_spills()

    for name, edits in ROWWISE_VARIANTS:
        print(f"== B6b: {name}", flush=True)
        readings = [("shipped", *times())]
        with built_with(edits):
            readings += [("variant", *times()) for _ in range(2)]
        readings.append(("shipped", *times()))
        for turn, one, queued, rows, spills in readings:
            print(f"  {turn}: B6b 20,000 rows {one:.4f} ms a call, {queued:.4f} ms a call of ten back to back; "
                  f"rows pass {rows:.4f} ms; spill stores, registers {spills}", flush=True)


def rows_variants(cs, device) -> None:
    from shapegan_tpu_torch import checkpoints

    params = checkpoints.load("sdf_net", base=os.path.join(cs.REPO, "shapegan_tpu", "examples"),
                              device=device)
    gen = torch.Generator().manual_seed(0)
    ops = K.grid_operands(params, voxel_coordinates(64, device=device),
                          (torch.randn((16, 128), generator=gen) * 0.1).to(device))
    g = torch.randn((16, 64**3), generator=gen).to(device)

    def rows_ms():
        return cs.time_ms(lambda: [K.grid_backward_rows_cuda(*cs.shapes_of(ops, g, s)) for s in range(16)],
                          iters=5)

    # The card's own store and copy rates on a 2 GiB buffer, the yardstick
    # for the rows pass's 8.7 KB a row.
    buf = torch.empty(2**30, dtype=torch.bfloat16, device=device)
    other = torch.empty_like(buf)
    zero_ms = cs.time_ms(buf.zero_, iters=5)
    copy_ms = cs.time_ms(lambda: other.copy_(buf), iters=5)
    print(f"== zero_ of 2 GiB: {zero_ms:.3f} ms ({2**31 / zero_ms / 1e9:.3f} TB/s written); copy_: "
          f"{copy_ms:.3f} ms ({2**32 / copy_ms / 1e9:.3f} TB/s read + written)", flush=True)
    del buf, other
    for name, edits in ROWS_VARIANTS:
        print(f"== rows pass: {name}", flush=True)
        readings = [("shipped", rows_ms())]
        with built_with(edits):
            readings += [("variant", rows_ms()), ("variant", rows_ms())]
        readings.append(("shipped", rows_ms()))
        for turn, ms in readings:
            print(f"  {turn}: B2 rows pass 16 x 64^3 {ms:.3f} ms", flush=True)


PASSES = "sdf_bwd_passes_sm90.cuh"
# (name, edits): the design choices of B2's passes 2-4, and two diagnoses.
PASSES_VARIANTS = (
    ("dz's two reads apart (the two halves of a (layer, slab) not neighbouring items)",
     [(PASSES, """  it.half = i % 2;
  it.slab = (i / 2) % SLABS;
  it.layer = i / (2 * SLABS);""", """  it.half = i / (LAYERS * SLABS);
  it.slab = i % SLABS;
  it.layer = (i / SLABS) % LAYERS;""")]),
    ("a ring of 8 stages of 32 rows (the shipped: 4 of 64)",
     [(PASSES, "constexpr int KT = 64; ", "constexpr int KT = 32; "),
      (PASSES, "constexpr int STAGES = 4; ", "constexpr int STAGES = 8; ")]),
    ("no column sums in the weight kernel (their cost; d_b wrong)",
     [(PASSES, "      column_sums(s.b[pos.stage][0], wg * (KT / 2), cs);\n", "")]),
    ("the fan-in without reading d_pp back (the read-modify-write's cost; d_pp wrong)",
     [(PASSES, "pp1[i] = ok ? *reinterpret_cast<const float4*>(a.pp1 + o) : zero;", "pp1[i] = zero;"),
      (PASSES, "pp5[i] = ok ? *reinterpret_cast<const float4*>(a.pp5 + o) : zero;", "pp5[i] = zero;")]),
)


def passes_variants(cs, device) -> None:
    from shapegan_tpu_torch import checkpoints

    params = checkpoints.load("sdf_net", base=os.path.join(cs.REPO, "shapegan_tpu", "examples"),
                              device=device)
    gen = torch.Generator().manual_seed(0)
    ops = K.grid_operands(params, voxel_coordinates(64, device=device),
                          (torch.randn((16, 128), generator=gen) * 0.1).to(device))
    g = torch.randn((16, 64**3), generator=gen).to(device)
    planes = K.grid_backward_rows_cuda(*cs.shapes_of(ops, g, 0))
    # The yardstick, off the main path: the weight products of the same
    # sixteen chunks as one PyTorch call each, torch.bmm of h_l^T and dz_l
    # in float32 (TF32 off), the operands converted beforehand.
    torch.backends.cuda.matmul.allow_tf32 = False
    h_t = planes[0][:6].float().transpose(1, 2)
    dz = planes[1].float()
    bmm_ms = cs.time_ms(lambda: [torch.bmm(h_t, dz) for _ in range(16)], iters=5)
    h_bf, dz_bf = planes[0][:6].transpose(1, 2), planes[1]
    bmm_bf16_ms = cs.time_ms(lambda: [torch.bmm(h_bf, dz_bf) for _ in range(16)], iters=5)
    del h_t, dz, h_bf, dz_bf
    torch.cuda.empty_cache()
    print(f"== torch.bmm of h_l^T and dz_l, 16 one-shape chunks at 64^3: float32 {bmm_ms:.3f} ms; "
          f"bf16 in and out {bmm_bf16_ms:.3f} ms", flush=True)

    def passes_ms():
        b2 = cs.time_ms(lambda: K.grid_backward_cuda(*ops, g), iters=5)
        alone = cs.time_ms(lambda: [K.grid_backward_passes_cuda(*planes, 1, 64**3, s) for s in range(16)], iters=5)
        torch.cuda.empty_cache()
        return b2, alone

    for name, edits in PASSES_VARIANTS:
        print(f"== passes: {name}", flush=True)
        readings = [("shipped", *passes_ms())]
        with built_with(edits):
            readings += [("variant", *passes_ms()), ("variant", *passes_ms())]
        readings.append(("shipped", *passes_ms()))
        for turn, b2, alone in readings:
            print(f"  {turn}: B2 16 x 64^3 {b2:.3f} ms | passes 2-4 alone, 16 one-shape chunks {alone:.3f} ms",
                  flush=True)


def stash_variants(cs, device) -> None:
    """B5b at 16 x 64^3 (random weights, chip_smoke's stash case) at each
    set of STASH_SETS, on the shipped B5a's planes: one call (CUDA events)
    and its rows pass's device time (torch.profiler), with the rows pass's
    spills, shipped / variant / variant / shipped."""
    ops, g = cs.stash_case(sdf_mlp.init(torch.Generator().manual_seed(1), device=device),
                           voxel_coordinates(64, device=device), 16, 13, device)

    def times(stash):
        planes = K.grid_forward_stash_cuda(*ops, stash)[1]
        call = lambda: K.grid_backward_stash_cuda(*ops, g, planes, stash)  # noqa: E731
        out = cs.time_ms(call, iters=5), cs.grid_bwd_split(call)[0]
        del planes
        torch.cuda.empty_cache()
        return out

    for name, edits in STASH_VARIANTS:
        print(f"== B5b: {name}", flush=True)
        readings = [("shipped", {stash: times(stash) for stash in cs.STASH_SETS}, rows_spills())]
        with built_with(edits):
            readings += [("variant", {stash: times(stash) for stash in cs.STASH_SETS}, rows_spills())
                         for _ in range(2)]
        readings.append(("shipped", {stash: times(stash) for stash in cs.STASH_SETS}, rows_spills()))
        for turn, by_set, spills in readings:
            print(f"  {turn}: " + "; ".join(f"B5b {stash} {ms:.3f} ms, rows pass {rows:.3f} ms"
                                            for stash, (ms, rows) in by_set.items())
                  + f"; spill stores, registers {spills}", flush=True)


def grid_variants(cs, device) -> None:
    from shapegan_tpu_torch import checkpoints

    params = checkpoints.load("sdf_net", base=os.path.join(cs.REPO, "shapegan_tpu", "examples"),
                              device=device)
    ops = K.grid_operands(params, voxel_coordinates(64, device=device), cs.path_latents(device)[1])
    stash = cs.FULL_STASH

    def grid_ms():
        b1 = cs.time_ms(lambda: K.grid_forward_cuda(*ops), iters=10)
        b5a = cs.time_ms(lambda: K.grid_forward_stash_cuda(*ops, stash), iters=5)
        torch.cuda.empty_cache()
        return b1, b5a

    for name, edits in GRID_VARIANTS:
        print(f"== grid: {name}", flush=True)
        readings = [("shipped", *grid_ms())]
        with built_with(edits):
            readings += [("variant", *grid_ms()), ("variant", *grid_ms())]
        readings.append(("shipped", *grid_ms()))
        for turn, b1, b5a in readings:
            print(f"  {turn}: B1 16 x 64^3 {b1:.3f} ms | B5a {stash} {b5a:.3f} ms", flush=True)


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    device = torch.device("cuda", 0)
    print(f"== {torch.cuda.get_device_name(0)}; {cs.nvidia_smi_line()}", flush=True)
    if "grid" in argv or not argv:
        grid_variants(cs, device)
    if "rows" in argv or not argv:
        rows_variants(cs, device)
    if "passes" in argv or not argv:
        passes_variants(cs, device)
    if "rowwise" in argv or not argv:
        rowwise_variants(cs, device)
    if "point_gen" in argv or not argv:
        point_gen_variants(cs, device)
    if "stash" in argv or not argv:
        stash_variants(cs, device)
    if argv and "trunk" not in argv:
        return 0
    chair, code = fit_chair(device)
    folded = sdf_mlp.fold_latent(chair, code)
    points = K.points_operands(folded, voxel_coordinates(128, device=device), code[:0])
    _, pts, dirs, status, escape, kw = cs.trace_cases(folded, device)[0]
    trace = (pts, dirs, status, escape) + K.point_weights(folded, code[:0])

    def times(with_trace: bool):
        b3 = cs.time_ms(lambda: K.points_forward_cuda(*points), iters=20)
        b4 = cs.time_ms(lambda: K.trace_steps_cuda(*trace, **kw), iters=5) if with_trace else None
        return b3, b4

    def show(label, b3, b4):
        b4_text = "not timed (the results change)" if b4 is None else f"{b4:.3f} ms"
        print(f"  {label}: B3 128^3 {b3:.3f} ms | B4 chair 1600^2 x k=20 {b4_text}", flush=True)

    for name, edits, exact in VARIANTS:
        print(f"== {name}", flush=True)
        readings = [("shipped", *times(exact))]
        with built_with(edits):
            readings += [("variant", *times(exact)), ("variant", *times(exact))]
        readings.append(("shipped", *times(exact)))
        for turn, b3, b4 in readings:
            show(turn, b3, b4)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

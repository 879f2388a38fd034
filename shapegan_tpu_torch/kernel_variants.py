#!/usr/bin/env python3
"""The design choices of the wgmma trunk (``ops/csrc/sdf_trunk_sm90.cuh``),
of the grid forward B1 and its stash instance B5a (``ops/csrc/sdf_grid.cu``)
and of the grid backward's Hopper rows pass (``ops/csrc/sdf_grid_bwd_sm90.cuh``),
timed against the shipped kernels. On one GPU:

    python -m shapegan_tpu_torch.kernel_variants [trunk | rows | grid]

Each variant is the shipped source with one choice undone, built in a
temporary directory (never in the checkout) as ``kernel_mutants`` builds
its wrong kernels, and timed in turns with the shipped build (shipped,
variant, variant, shipped; CUDA events, medians): B3 at 128^3 and B4 on the
chair's 1600^2 primary rays x k=20, chip_smoke's main-path shapes. A
variant that changes the results is timed on B3 only (B4's work would
change with them) and says so. The rows-pass variants are timed by B2's
rows pass at 16 x 64^3 (bundled weights, sixteen one-shape calls of
``grid_backward_rows_cuda``), whatever they do to the results; the grid
variants by B1 and B5a (stash set (1..6)) at 16 x 64^3 (bundled weights).
With an argument only that group runs.
"""

from __future__ import annotations

import os
import sys

import torch

from shapegan_tpu_torch.examples import fit_chair
from shapegan_tpu_torch.kernel_mutants import _chip_smoke, built_with
from shapegan_tpu_torch.ops import sdf_mlp
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

#!/usr/bin/env python3
"""The design choices of the wgmma trunk (``ops/csrc/sdf_trunk_sm90.cuh``),
timed against the shipped kernels. On one GPU:

    python -m shapegan_tpu_torch.kernel_variants

Each variant is the shipped source with one choice undone, built in a
temporary directory (never in the checkout) as ``kernel_mutants`` builds
its wrong kernels, and timed in turns with the shipped build (shipped,
variant, variant, shipped; CUDA events, medians): B3 at 128^3 and B4 on the
chair's 1600^2 primary rays x k=20, chip_smoke's main-path shapes. A
variant that changes the results is timed on B3 only (B4's work would
change with them) and says so.
"""

from __future__ import annotations

import sys

import torch

from shapegan_tpu_torch.examples import fit_chair
from shapegan_tpu_torch.kernel_mutants import _chip_smoke, built_with
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.ops.coords import voxel_coordinates

TRUNK = "sdf_trunk_sm90.cuh"
_NO_TURNS = [(TRUNK, "  named_sync(TURN_BARRIER + wg, 128 * CONSUMERS);\n", ""),
             (TRUNK, "  named_arrive(TURN_BARRIER + (1 - wg), 128 * CONSUMERS);  // the other consumer's turn\n", "")]
# (name, edits, whether the results stay the kernel's)
VARIANTS = (
    ("no ping-pong (the consumers issue their products when they like)",
     _NO_TURNS, True),
    ("a 4-stage ring", [(TRUNK, "constexpr int STAGES = 6;", "constexpr int STAGES = 4;")], True),
    ("no weight traffic after the ring's first fill (stale weights: the L2 traffic's cost)",
     [(TRUNK, """    bar_expect(&s.full[pos.stage], SLICE_BYTES);
    load_slice(s.ring[pos.stage], map, chunk, &s.full[pos.stage]);""",
       """    if (issued < STAGES) {
      bar_expect(&s.full[pos.stage], SLICE_BYTES);
      load_slice(s.ring[pos.stage], map, chunk, &s.full[pos.stage]);
    } else {
      bar_expect(&s.full[pos.stage], 0);
    }""")], False),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    device = torch.device("cuda", 0)
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

    print(f"== {torch.cuda.get_device_name(0)}; {cs.nvidia_smi_line()}", flush=True)
    for name, edits, exact in VARIANTS:
        print(f"== {name}", flush=True)
        readings = []
        for turn in ("shipped", "variant", "variant", "shipped"):
            if turn == "shipped":
                readings.append((turn, *times(exact)))
            else:
                with built_with(edits):
                    readings.append((turn, *times(exact)))
        for turn, b3, b4 in readings:
            show(turn, b3, b4)
    return 0


if __name__ == "__main__":
    sys.exit(main())

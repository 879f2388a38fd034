"""The generator's grid backward in the G steps (twice the forward's
operations, counts.grid_backward) over the device time of the kernels that
implement it: B2's rows pass, its passes 2-4 and their finishes."""

from benchmark import readers

PATTERNS = ("bwd_rows_sm90_kernel", "sdf90_passes::", "bwd_finish_kernel")


def read(reading):
    return readers.roofline(reading, "grid_bwd", PATTERNS)

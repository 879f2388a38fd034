"""The sphere trace: the evaluations that the reference's plain trace of
the same rays needs (primary and shadow) over the device time of the
kernels that evaluate trace steps (B4, and the points kernel where a
trace runs step by step)."""

from benchmark import readers

PATTERNS = ("sdf_trace_kernel", "sdf_points_kernel")


def read(reading):
    return readers.roofline(reading, "trace", PATTERNS)

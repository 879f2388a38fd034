"""The grid forward of the requests (counts.grid_forward) over the device
time of the kernel that implements it: B1 (the points kernel for a request
of one latent)."""

from benchmark import readers

PATTERNS = ("sdf_grid_kernel", "sdf_points_kernel")


def read(reading):
    return readers.roofline(reading, "grid_fwd", PATTERNS)

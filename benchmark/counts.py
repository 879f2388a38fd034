"""The operations and bytes of the work that the cells time, counted from
shapes by the rules written beside each term. The counts are those of the
operation, not of whatever kernels run it today, so that a later change
that fuses, splits or moves work reads the same work.

A multiply-add is 2 operations. Bytes: each input read once and each
output written once, float32 (4 bytes) unless stated."""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks() -> dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def sdf_point_flops(width: int) -> int:
    """One point through the DeepSDF MLP with its latent's part already
    added (the part is counted once per shape, below): layer 1's point
    part (3 -> W), layers 2-4 (W -> W), layer 5's hidden and point parts
    (W + 3 -> W), layers 6-7 (W -> W), layer 8 (W -> 1)."""
    return 2 * (3 * width + 3 * width * width + (width + 3) * width + 2 * width * width + width)


def sdf_shape_flops(width: int, latent: int) -> int:
    """One shape's latent parts of layers 1 and 5 (L -> W, twice)."""
    return 2 * 2 * latent * width


def sdf_param_count(width: int, latent: int) -> int:
    first, skip = 3 + latent, width + 3 + latent
    return (first * width + width) + 3 * (width * width + width) \
        + (skip * width + width) + 2 * (width * width + width) + (width + 1)


def grid_forward(shapes: int, points: int, width: int, latent: int):
    """(flops, bytes) of ``shapes`` latents over ``points`` shared points:
    reads the points, the latents and the weights, writes [shapes, points]."""
    flops = shapes * points * sdf_point_flops(width) + shapes * sdf_shape_flops(width, latent)
    nbytes = 4 * (3 * points + shapes * latent + sdf_param_count(width, latent) + shapes * points)
    return flops, nbytes


def grid_backward(shapes: int, points: int, width: int, latent: int):
    """(flops, bytes) of the gradient of a grid forward's output for the
    weights, the points and the latents: twice the forward's operations (the
    two products of each layer's backward), no recompute. Reads the points,
    latents, weights and the output's gradient; writes the gradients of the
    weights, the points and the latents."""
    flops = 2 * grid_forward(shapes, points, width, latent)[0]
    params = sdf_param_count(width, latent)
    nbytes = 4 * (3 * points + shapes * latent + params + shapes * points) \
        + 4 * (params + 3 * points + shapes * latent)
    return flops, nbytes


def trace_flops(evaluations: int, width: int) -> int:
    """Sphere-trace steps: one latent-free evaluation each (the frame's code
    is one shape's, its part counted once and negligible)."""
    return evaluations * sdf_point_flops(width)


def critic_forward_flops(critic: dict, resolution: int, iteration: int, batch: int) -> int:
    """One forward pass of the progressive critic at ``resolution`` (growth
    ``iteration``): each conv (k^3 taps, stride 2) and the two dense layers."""
    counts = critic["feature_counts"]
    k3 = critic["kernel"] ** 3
    flops, res, c_in = 0, resolution, 1  # the entry conv reads the one real channel
    for i in range(iteration, -1, -1):
        c_out = counts[i - 1] if i > 0 else critic["final_features"]
        res //= 2
        flops += 2 * res ** 3 * c_out * c_in * k3
        c_in = c_out
    flops += 2 * (64 * critic["final_features"] * critic["head_features"] + critic["head_features"])
    return batch * flops


# Passes of the critic, in forwards: a forward 1, its backward 2 (the data
# and weight products); the D step runs fakes and reals forward and
# backward, and the penalty a forward, a data gradient (1) and the
# second-order pass over both (2 x 2).
CRITIC_PASSES_D_STEP = 3 + 3 + (1 + 1 + 4)
# The G step: a forward and the data gradient back to the volumes.
CRITIC_PASSES_G_STEP = 2


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the bf16 dense peak and the bytes over the memory bandwidth."""
    p = peaks()
    return max(flops / p["bf16_dense_flops"], nbytes / p["hbm_bytes_per_s"])

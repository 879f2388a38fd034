"""Arithmetic that the per-layer metrics' readers share. A reader that finds
nothing to read returns None, and the harness leaves its metric out."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark import counts

# Every hand-written kernel of the program (shapegan_tpu_torch/ops/csrc),
# by a part of its name as the profiler shows it.
PORT_KERNELS = ("sdf_grid_kernel", "sdf_points_kernel", "sdf_trace_kernel",
                "bwd_rows_sm90_kernel", "sdf90_passes::", "bwd_finish_kernel",
                "sdf_rowwise_kernel", "tail_kernel", "point_gen_kernel")


def mean_ms(reading, *spans: str, per: Optional[str] = None) -> Optional[float]:
    """The spans' total over their count (or over the count of ``per``), ms."""
    values = [s for name in spans for s in reading.spans.get(name, [])]
    n = len(reading.spans.get(per, [])) if per else len(values)
    return 1e3 * sum(values) / n if values and n else None


def roofline(reading, operation: str, patterns: Sequence[str]) -> Optional[float]:
    """The least time of ``operation``'s work in the window over the device
    time of the kernels that implement it, in percent."""
    flops, nbytes = reading.work.get(operation, (0, 0))
    if reading.device is None or not flops:
        return None
    seconds = reading.device.device_seconds(patterns)
    if seconds <= 0:
        return None
    return 100.0 * counts.least_seconds(flops, nbytes) / seconds


def mfu(reading) -> Optional[float]:
    """The whole step's operations over the window, as a share of the bf16
    dense peak (every operation counted against it, the critic's TF32
    convolutions too), in percent."""
    if not reading.model_flops or reading.window_s <= 0:
        return None
    return 100.0 * reading.model_flops / (reading.window_s * counts.peaks()["bf16_dense_flops"])


def idle(reading) -> Optional[float]:
    """The share of the traced window with no operation on the device, %."""
    if reading.device is None or reading.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - reading.device.busy_s / reading.device.window_s)

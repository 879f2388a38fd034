"""The share of the window's G and D steps that ran as the replay of a
captured CUDA graph (the program's counter ``train.graph_replays`` over the
steps the window counted), in percent. Below 100: steps issued eagerly,
kernel by kernel, where the host may pace the device. A program that
replays no graph has no such counter, and the reader returns None."""

from benchmark import program_trace


def read(reading):
    replays = program_trace.counter("train.graph_replays")
    steps = reading.counts.get("g_steps", 0) + reading.counts.get("d_steps", 0)
    return 100.0 * replays / steps if replays and steps else None

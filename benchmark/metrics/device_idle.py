"""The share of the traced window in which no operation ran on the device
(torch.profiler)."""

from benchmark import readers


def read(reading):
    return readers.idle(reading)

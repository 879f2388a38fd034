"""Mean length of a D step call (``make_steps``' ``d_step``) in the traced
window, on the device's clock: CUDA events before and after each call."""

from benchmark import readers


def read(reading):
    return readers.mean_ms(reading, "d_step")

"""Mean time per frame of the renderer's two traces (primary and shadow),
from the program's own ``render_image(on_phase=...)`` hook, on the
device's clock (a CUDA event at each phase's end)."""

from benchmark import readers


def read(reading):
    return readers.mean_ms(reading, "primary trace", "shadow trace", per="frame")

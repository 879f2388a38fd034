"""Mean time per frame of the renderer's normals phase (B1 and B2 on every
lane), from the program's own ``render_image(on_phase=...)`` hook, on the
device's clock."""

from benchmark import readers


def read(reading):
    return readers.mean_ms(reading, "normals", per="frame")

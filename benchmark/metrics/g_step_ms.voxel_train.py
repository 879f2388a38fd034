"""Mean length of a voxel GAN G step call (``train.gan.make_steps``'
``g_step``) in the traced window, on the device's clock: CUDA events
before and after each call."""

from benchmark import readers


def read(reading):
    return readers.mean_ms(reading, "g_step")

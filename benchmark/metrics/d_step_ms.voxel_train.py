"""Mean length of a voxel GAN D step call (``train.gan.make_steps``'
``d_step``: the fakes and both discriminator updates) in the traced
window, on the device's clock: CUDA events before and after each call."""

from benchmark import readers


def read(reading):
    return readers.mean_ms(reading, "d_step")

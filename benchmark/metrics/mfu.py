"""The whole step's model operations over the traced window, as a share of
the card's bf16 dense peak (counts.py: the SDF network's eight layers per
point, its latent part once per shape, a backward twice its forward; the
critic's passes; the frame's trace, normals and shadows as the reference
needs them)."""

from benchmark import readers


def read(reading):
    return readers.mfu(reading)

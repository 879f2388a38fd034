"""shapegan_tpu_torch — the PyTorch/CUDA port of :mod:`shapegan_tpu` for one
NVIDIA H100.

Module names mirror ``shapegan_tpu/`` so each counterpart is easy to find.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package that a
ported path runs is a hand-written CUDA kernel under ``ops/csrc/``, with a
plain PyTorch version of the same math beside its wrapper
(:mod:`shapegan_tpu_torch.ops.sdf_mlp_kernels`). The package never imports
jax; the JAX package stays the reference its tests are held against.
"""

__version__ = "0.1.0"

LATENT_CODE_SIZE = 128
SDF_CLIPPING = 0.1

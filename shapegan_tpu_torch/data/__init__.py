"""Datasets for the port (jax-free; the numpy host modules of
:mod:`shapegan_tpu.data` are imported from there)."""

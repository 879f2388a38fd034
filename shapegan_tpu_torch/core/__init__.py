"""Configuration + reference-compatible CLI (jax-free)."""

from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device  # noqa: F401

"""Structured configuration with the reference CLI vocabulary preserved.

Same vocabulary as :mod:`shapegan_tpu.core.config`: bare tokens
(``continue``, ``nogui``, ``show_slice``, ``verbose``, ``classic``, ``cpu``,
``synthetic``), ``name=value`` pairs and ``--name value`` flags. Only the
settings a ported entry point reads are fields of :class:`TrainConfig`,
under the JAX package's names and defaults; every other name lands in
``extras`` under its field name in the JAX package (``continue`` →
``resume``). The one difference is what ``cpu``
means: here it selects ``device="cpu"`` explicitly. Without it the device
is ``cuda``, and :func:`resolve_device` raises when CUDA is missing instead
of carrying on on the CPU.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional

import torch


@dataclasses.dataclass
class TrainConfig:
    resume: bool = False          # 'continue'
    nogui: bool = True            # 'gui' asks for the live viewer (train.common.make_viewer)
    show_slice: bool = False
    verbose: bool = False
    classic: bool = False         # the autoencoder trainer: the classic AE instead of the VAE
    iteration: int = 0            # progressive growth iteration
    epochs: Optional[int] = None
    category: str = "chairs"
    cpu: bool = False             # run on the CPU instead of the GPU
    synthetic: int = 0            # train on N synthetic analytic shapes
    batch_size: Optional[int] = None
    data_dir: str = "data"
    model_dir: str = "models"
    plot_dir: str = "plots"
    seed: int = 0
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> str:
        return "cpu" if self.cpu else "cuda"


_FIELDS = {f.name for f in dataclasses.fields(TrainConfig)} - {"extras"}
_INT_KEYS = {"iteration", "epochs", "synthetic", "batch_size", "seed"}

# bare token → (name, value)
BOOL_TOKENS = {
    "continue": ("resume", True),
    "nogui": ("nogui", True),
    "gui": ("nogui", False),
    "show_slice": ("show_slice", True),
    "verbose": ("verbose", True),
    "classic": ("classic", True),
    "cpu": ("cpu", True),
    "synthetic": ("synthetic", 50),
}


def parse_cli(argv: Optional[List[str]] = None, **defaults) -> TrainConfig:
    """Parse reference-style CLI tokens into a TrainConfig.

    Accepted forms: bare tokens (``continue``, ``nogui`` …), ``name=value``
    pairs (``iteration=2``), and ``--name value`` / ``--name=value`` flags.
    """
    if argv is None:
        argv = sys.argv[1:]
    cfg = TrainConfig(**defaults)

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            body = arg[2:]
            if "=" in body:
                key, value = body.split("=", 1)
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                key, value = body, argv[i + 1]
                i += 1
            else:
                key, value = body, "true"
            _assign(cfg, key.replace("-", "_"), value)
        elif "=" in arg:
            key, value = arg.split("=", 1)
            _assign(cfg, key.replace("-", "_"), value)
        elif arg in BOOL_TOKENS:
            key, value = BOOL_TOKENS[arg]
            if key in _FIELDS:
                setattr(cfg, key, value)
            else:
                cfg.extras[key] = value
        else:
            cfg.extras[arg] = True
        i += 1
    return cfg


def resolve_device(cfg: TrainConfig) -> torch.device:
    """The device an entry point runs on: ``cpu`` only when asked for by the
    ``cpu`` token, otherwise CUDA — and an error if there is none."""
    if cfg.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass the 'cpu' token to run on the CPU"
        )
    return torch.device(cfg.device)


def _assign(cfg: TrainConfig, key: str, value: str) -> None:
    if key == "continue":
        key = "resume"
    if key not in _FIELDS:
        cfg.extras[key] = _coerce(value)
    elif key in _INT_KEYS:
        setattr(cfg, key, int(value))
    elif isinstance(getattr(cfg, key), bool):
        setattr(cfg, key, value.lower() in ("1", "true", "yes"))
    else:
        setattr(cfg, key, value)


def _coerce(value: str):
    try:
        return int(value)
    except ValueError:
        try:
            return float(value)
        except ValueError:
            return value

"""Checkpoint reading with the JAX package's layout (counterpart of the read
side of :mod:`shapegan_tpu.checkpoints`).

A checkpoint is ``models/<name>.npz`` (or the snapshot
``models/checkpoints/<name>-epoch-%05d.npz``) keyed by flattened parameter
paths; for the SDF MLP the keys are its parameter names (``w1p``, ``b1`` …)
in the ``[in, out]`` layout. When the latest slot is missing, ``load`` and
``load_array`` read the bundled example in ``shapegan_tpu/examples/`` in
place; the bundle is fp16 and comes back as float32.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

MODEL_PATH = "models"
EXAMPLES_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "shapegan_tpu", "examples")


def _example_fallback(name: str, epoch: Optional[int], base: Optional[str]) -> Optional[str]:
    """Bundled-example path to use instead, or None."""
    if epoch is not None or (base or MODEL_PATH) != MODEL_PATH:
        return None  # explicit snapshot/base requests never silently switch
    candidate = os.path.join(EXAMPLES_PATH, f"{name}.npz")
    if os.path.exists(candidate):
        print(f"checkpoint models/{name}.npz not found; using bundled example {candidate}")
        return candidate
    return None


def checkpoint_dir(base: Optional[str] = None) -> str:
    return os.path.join(base or MODEL_PATH, "checkpoints")


def get_filename(name: str, epoch: Optional[int] = None, base: Optional[str] = None) -> str:
    """models/<name>.npz or models/checkpoints/<name>-epoch-00042.npz."""
    base = base or MODEL_PATH
    if epoch is None:
        return os.path.join(base, f"{name}.npz")
    return os.path.join(checkpoint_dir(base), f"{name}-epoch-{epoch:05d}.npz")


def _resolve(name: str, epoch: Optional[int], base: Optional[str]) -> str:
    path = get_filename(name, epoch, base)
    if not os.path.exists(path):
        path = _example_fallback(name, epoch, base) or path
    return path


def load(name: str, epoch: Optional[int] = None, base: Optional[str] = None,
         device="cpu") -> Dict[str, torch.Tensor]:
    """Every array of a checkpoint as a tensor on ``device``; floating-point
    arrays come back as float32."""
    with np.load(_resolve(name, epoch, base)) as data:
        stored = {k: data[k] for k in data.files}
    return {k: torch.tensor(v.astype(np.float32) if v.dtype.kind == "f" else v, device=device)
            for k, v in stored.items()}


def load_array(name: str, epoch: Optional[int] = None, base: Optional[str] = None) -> np.ndarray:
    """A standalone array artifact (the latent-code table), float32 if it
    was stored as fp16."""
    with np.load(_resolve(name, epoch, base)) as data:
        array = data["array"]
    if array.dtype == np.float16:
        array = array.astype(np.float32)
    return array

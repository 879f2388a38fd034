"""Checkpoints in the JAX package's layout (counterpart of
:mod:`shapegan_tpu.checkpoints`).

A checkpoint is ``models/<name>.npz`` (or the snapshot
``models/checkpoints/<name>-epoch-%05d.npz``) keyed by flattened tree
paths, ``/``-joined: for the SDF MLP the keys are its parameter names
(``w1p``, ``b1`` …) in the ``[in, out]`` layout; a nested dict or sequence
adds one path part per level (``optional_layers_0/kernel``, the optimizer
sidecar's ``g/0/nu/w1p``). Files written here load into the JAX package and
the other way round. When the latest slot is missing, ``load``,
``load_tree`` and ``load_array`` read the bundled example in
``shapegan_tpu/examples/`` in place; the bundle is fp16 and comes back as
float32 (``load``, ``load_array``) or as the template's type
(``load_tree``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

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


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        return {prefix: np.asarray(tree)}
    flat = {}
    for key, value in items:
        flat.update(_flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def save(tree: Any, name: str, epoch: Optional[int] = None, base: Optional[str] = None) -> str:
    """Save a nested dict/sequence of tensors or arrays to the latest slot
    (``epoch=None``) or an epoch snapshot; written to a temporary file and
    renamed, so a reader never sees half a file. Under a process group
    only rank 0 writes (every rank holds the same replicated state); the
    others return the path without writing."""
    from shapegan_tpu_torch.parallel.mesh import is_writer

    path = get_filename(name, epoch, base)
    if not is_writer():
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)
    return path


def save_array(array, name: str, epoch: Optional[int] = None, base: Optional[str] = None) -> str:
    """A standalone array artifact, stored under the key ``array``."""
    return save({"array": array}, name, epoch, base)


def exists(name: str, epoch: Optional[int] = None, base: Optional[str] = None) -> bool:
    """Whether the user's own checkpoint exists (the bundled examples do not
    count, so a trainer starts fresh without one)."""
    return os.path.exists(get_filename(name, epoch, base))


def load_tree(template: Any, name: str, epoch: Optional[int] = None, base: Optional[str] = None,
              strict: bool = False) -> Any:
    """Restore a tree shaped like ``template`` (nested dicts/sequences of
    tensors). Each stored value takes its template leaf's dtype and device.
    With ``strict=False`` a key the file lacks keeps the template's value and
    a key the template lacks is ignored (what progressive warm starts need);
    with ``strict=True`` both, and a shape mismatch, raise."""
    path = _resolve(name, epoch, base)
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    used = set()

    def restore(node, prefix):
        if isinstance(node, Mapping):
            return {k: restore(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(restore(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(node))
        if prefix not in stored:
            if strict:
                raise KeyError(f"checkpoint {path} is missing key {prefix}")
            return node
        value = stored[prefix]
        if strict and tuple(value.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch for {prefix}: {value.shape} vs {tuple(node.shape)}")
        used.add(prefix)
        return torch.tensor(value, device=node.device).to(node.dtype)

    tree = restore(template, "")
    if strict and used != set(stored):
        raise KeyError(f"checkpoint {path} has unused keys: {sorted(set(stored) - used)}")
    return tree

"""Pieces the drivers share: the device's clock, norms by leaf, patches."""

from __future__ import annotations

import contextlib
import math
import statistics
import time
from typing import Dict

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now(device) -> float:
    """The host clock after the device has finished what was queued."""
    sync(device)
    return time.perf_counter()


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap between two norms, |got - ref|, over the larger of
    that leaf's reference norm and the median leaf's."""
    keys = [k for k in ref if keep is None or k in keep]
    if set(got) != set(ref):
        return {k: math.inf for k in keys}
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(got[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def worst_and_median_gap(got: Dict[str, float], ref: Dict[str, float], keep=None):
    """The widest and the median of :func:`leaf_gaps`."""
    gaps = list(leaf_gaps(got, ref, keep).values())
    return max(gaps), statistics.median(gaps)


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def widest_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    if got.shape != ref.shape:
        return math.inf
    return float((got.double() - ref.double()).abs().max())


@contextlib.contextmanager
def patched(owner, name: str, value):
    """``owner.name = value`` inside, restored after (the faults' plant)."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)

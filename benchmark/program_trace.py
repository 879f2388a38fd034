"""What the program's own spans and counters (``shapegan_tpu_torch.tracing``)
saw while the traced window was profiled: the profiler records the window
alone, so the record is the window's. Each span's calls and host seconds
(the host's clock: how long the program took to issue the work), each
counter's increase. A program without that module (an older one) has
nothing to read, and its readers return None."""

from __future__ import annotations

from typing import Optional


def record() -> Optional[dict]:
    try:
        from shapegan_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.profiled()


def span_ms(*names: str, per: Optional[float] = None) -> Optional[float]:
    """The spans' host milliseconds over their calls, or over ``per``."""
    seen = record()
    if seen is None:
        return None
    found = [seen["spans"][n] for n in names if n in seen["spans"]]
    calls = sum(c for c, _ in found) if per is None else per
    if not found or not calls:
        return None
    return 1e3 * sum(s for _, s in found) / calls


def counter(name: str) -> Optional[int]:
    """The counter's increase in the window (None where it never moved)."""
    seen = record()
    return None if seen is None else seen["counts"].get(name)

"""The traced run's reading of the device: ``torch.profiler`` (CUPTI) over
the measured window, reduced to the device's busy time, the device time of
each kernel by name, and the idle gaps labelled by what the host was doing.

The window is the benchmark's own ``record_function("window")`` span, so
the profiler's warm-up before it and its flush after it are left out."""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "window"
# Host events looked back through to label one idle gap.
SCAN = 4096


@dataclass
class DeviceReading:
    window_s: float
    busy_s: float
    kernels: Dict[str, float] = field(default_factory=dict)   # name -> device seconds
    gaps: Dict[str, float] = field(default_factory=dict)      # host label -> idle seconds

    def device_seconds(self, patterns=None, exclude=None) -> float:
        """Device seconds of the operations whose name holds one of
        ``patterns`` (all when None) and none of ``exclude``."""
        total = 0.0
        for name, seconds in self.kernels.items():
            if patterns is not None and not any(p in name for p in patterns):
                continue
            if exclude is not None and any(p in name for p in exclude):
                continue
            total += seconds
        return total

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def _label(host: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The outermost benchmark span and the innermost host event that
    cover the time ``t`` (ns), as ``span/event``."""
    i = bisect.bisect_right(starts, t) - 1
    inner = None
    for i in range(i, max(i - SCAN, -1), -1):
        start, end, name = host[i]
        if end >= t and name != WINDOW:
            inner = name
            break
    return inner or "host outside any operation"


def read(prof, spans: Optional[set] = None) -> DeviceReading:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`DeviceReading`.
    ``spans``: names of the benchmark's own spans (profiler annotations,
    which the trace also shows on the device's timeline), used to prefix
    gap labels."""
    window = None
    device: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    outer: List[Tuple[int, int, str]] = []
    annotations = {WINDOW} | set(spans or ())
    for e in prof.profiler.kineto_results.events():
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # Kernels, copies and fills; the device-side copies of the
            # benchmark's own spans are not operations.
            if name not in annotations:
                device.append((start, start + dur, name))
        elif name == WINDOW:
            window = (start, start + dur)
        else:
            host.append((start, start + dur, name))
            if spans and name in spans:
                outer.append((start, start + dur, name))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window span")
    lo, hi = window
    kernels: Dict[str, float] = collections.defaultdict(float)
    clipped = []
    for start, end, name in device:
        s, t = max(start, lo), min(end, hi)
        if t > s:
            kernels[name] += (t - s) * 1e-9
            clipped.append((s, t))
    busy = _merge(clipped)
    host.sort()
    outer.sort()
    host_starts = [h[0] for h in host]
    outer_starts = [h[0] for h in outer]
    gaps: Dict[str, float] = collections.defaultdict(float)
    cursor = lo
    for start, end in busy + [(hi, hi)]:
        if start > cursor:
            mid = (cursor + start) // 2
            label = _label(host, host_starts, mid)
            if outer:
                label = f"{_label(outer, outer_starts, mid)}/{label}"
            gaps[label] += (start - cursor) * 1e-9
        cursor = max(cursor, end)
    return DeviceReading(window_s=(hi - lo) * 1e-9,
                         busy_s=sum(t - s for s, t in busy) * 1e-9,
                         kernels=dict(kernels), gaps=dict(gaps))

"""The program's spans and counters, on the profiler's clock.

* :func:`span` names a stretch of host work (``with span("sg.d_step"):``).
  While a ``torch.profiler`` records, it opens a profiler range of that
  name, a host event of the same trace as the device's operations, so the
  two share one clock; at all other times it costs one flag check. A span
  never synchronizes the device, records a CUDA event or allocates device
  memory. :func:`kernel` traces a hand kernel's wrapper so.
* :func:`count` adds to a process-wide counter of something the host
  already knows (a shape, a loop's trips), never a number read back from
  the device. Counting is always on; :func:`counters` reads the counters.
* :func:`profiled` gives what spans and counters saw while a profiler
  recorded (since the process started, or :func:`reset`): each span's
  calls and host seconds, and each counter's increase. A reader of one
  traced window, in a process that profiles that window alone, reads it
  after the profiler has stopped.

Every span is named ``sg.<layer>...``, dots within: the prefix sets the
program's ranges apart from aten operations and from a caller's own
ranges, which may be split at ``/``.

The ranges are ``torch._C._profiler._RecordFunctionFast``, the profiler's
operator scope, not ``torch.profiler.record_function``: a user range is
also drawn on the device's timeline as an annotation spanning the kernels
it launched, which a reader of the device's busy time would count as an
operation, and it costs ~10 us a call even with no profiler running."""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict

import torch

_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}
_PROFILED_COUNTS: Dict[str, int] = {}
_PROFILED_SPANS: Dict[str, list] = {}   # name -> [calls, host ns]


class _Span:
    __slots__ = ("_name", "_range", "_t0")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._range = _Range(self._name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        self._range.__exit__(*exc)
        with _LOCK:
            entry = _PROFILED_SPANS.setdefault(self._name, [0, 0])
            entry[0] += 1
            entry[1] += ns


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler
    records, nothing otherwise."""
    return _Span(name) if _enabled() else _OFF


def kernel(wrapper):
    """Decorate a hand kernel's wrapper ``<name>_cuda`` so that each call
    (its checks, allocations and the C launch) is the span
    ``sg.kernel.<name>``."""
    name = f"sg.kernel.{wrapper.__name__.removesuffix('_cuda')}"

    @functools.wraps(wrapper)
    def traced(*args, **kwargs):
        if not _enabled():
            return wrapper(*args, **kwargs)
        with _Span(name):
            return wrapper(*args, **kwargs)

    return traced


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
        if _enabled():
            _PROFILED_COUNTS[name] = _PROFILED_COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _LOCK:
        return dict(_COUNTS)


def profiled() -> dict:
    """What was seen while a profiler recorded: ``{"spans": {name: (calls,
    host seconds)}, "counts": {name: increase}}``."""
    with _LOCK:
        return {"spans": {k: (n, ns * 1e-9) for k, (n, ns) in _PROFILED_SPANS.items()},
                "counts": dict(_PROFILED_COUNTS)}


def reset() -> None:
    """Forget what :func:`profiled` returns (the counters stay)."""
    with _LOCK:
        _PROFILED_SPANS.clear()
        _PROFILED_COUNTS.clear()

"""Host microseconds per tensor that Adam updates: the program's spans
``sg.g_step.optimizer`` and ``sg.d_step.optimizer`` (Adam's loop over the
leaves, a dozen small operations a tensor) over its counter
``optim.adam_tensor_updates``, on the profiler's host clock. A program
without the counter has nothing to read."""

from benchmark import program_trace


def read(reading):
    updates = program_trace.counter("optim.adam_tensor_updates")
    if not updates:
        return None
    ms = program_trace.span_ms("sg.g_step.optimizer", "sg.d_step.optimizer", per=updates)
    return None if ms is None else 1e3 * ms

"""Host time per request of making the grid kernel's operands (the
program's span ``sg.generate.operands``: the weights' casts and stacks,
the point projections), on the profiler's host clock."""

from benchmark import program_trace


def read(reading):
    return program_trace.span_ms("sg.generate.operands", per=reading.counts.get("requests"))

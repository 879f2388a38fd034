"""Mean host length of a G step (the program's span ``sg.g_step``): the
time the host takes to issue one G step, on the profiler's host clock."""

from benchmark import program_trace


def read(reading):
    return program_trace.span_ms("sg.g_step")

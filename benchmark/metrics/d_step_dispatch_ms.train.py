"""Mean host length of a D step (the program's span ``sg.d_step``): the
time the host takes to issue one D step, on the profiler's host clock.
Where it nears ``d_step_ms.train``, the host paces the step."""

from benchmark import program_trace


def read(reading):
    return program_trace.span_ms("sg.d_step")

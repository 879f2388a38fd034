"""Host time per batch of both optimizers' updates (the program's spans
``sg.g_step.optimizer`` and ``sg.d_step.optimizer``: RMSprop's loop over
the leaves), on the profiler's host clock."""

from benchmark import program_trace


def read(reading):
    return program_trace.span_ms("sg.g_step.optimizer", "sg.d_step.optimizer",
                                 per=reading.counts.get("batches"))

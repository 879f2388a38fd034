"""Mean host length of a voxel GAN D step (the program's span
``sg.d_step`` in ``train.gan.make_steps``): the time the host takes to
dispatch one D step, on the profiler's host clock. Where it nears
``d_step_ms.voxel_train``, the host paces the step. A program without the
span has nothing to read."""

from benchmark import program_trace


def read(reading):
    return program_trace.span_ms("sg.d_step")

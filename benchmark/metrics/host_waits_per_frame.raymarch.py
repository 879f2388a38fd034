"""Host tests that wait for the device, per frame (the program's counter
``render.host_waits``: each any-active test and compaction count between
trace stages, and the frame's copy to the host). Each drains the device's
queue while the host waits."""

from benchmark import program_trace


def read(reading):
    waits = program_trace.counter("render.host_waits")
    frames = reading.counts.get("frames")
    return waits / frames if waits and frames else None

"""The share of the lane-steps that the renderer's traces launched (the
program's counter ``render.lane_steps``: lanes times iterations of every
trace launch, primary and shadow) that the reference's plain trace of the
same rays needs (the evaluations that ``work()`` counts for ``trace``), in
percent. Low: lanes launched in vain (resolved lanes riding along, buckets
wider than their live lanes), which no kernel speed recovers."""

from benchmark import counts, harness, program_trace


def read(reading):
    launched = program_trace.counter("render.lane_steps")
    flops = reading.work.get("trace", (0, 0))[0]
    if not launched or not flops:
        return None
    needed = flops / counts.sdf_point_flops(harness.cell(reading.cell).config["width"])
    return 100.0 * needed / launched

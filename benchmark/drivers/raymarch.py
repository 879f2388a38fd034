"""Closed-loop raymarched frames: ``render.raymarching.render_image(net,
code, resolution, ssaa)`` of the chair fitted in set-up from the seed, as
``demo_sdf_net mode=raymarch`` calls it (shadows on), one after another; a
frame ends with its uint8 pixels on the host. The traced run also times
the renderer's phases through its own ``on_phase`` hook, on the device's
clock.

The check compares every frame of the window with the float32
reference's frame of the same chair."""

from __future__ import annotations

import hashlib
import time
import types
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import counts, seeds
from benchmark.drivers import common
from benchmark.inputs import chair, weights
from benchmark.reference import raymarch
from benchmark.reference.precision import Precision, no_tf32

PHASES = ("primary trace", "normals", "shadow trace", "shading and downsample")


@dataclass
class State:
    cell: object
    device: torch.device
    params: dict
    code: torch.Tensor
    program: Optional[types.SimpleNamespace] = None
    frames: List[np.ndarray] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)
    needed: Dict[str, int] = field(default_factory=dict)


def setup(cell, seed: int, device) -> State:
    from shapegan_tpu_torch.models.sdf_net import SDFNet

    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "chair"))
    params, code = chair.fit(cell.config, gen, device)
    common.free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = State(cell, device, params, code)
    state.program = types.SimpleNamespace(net=SDFNet(weights.clone(params), device=device))
    for _ in range(cell.traffic["warm_frames"]):
        frame(state)
    state.frames = []
    state.counts = {"frames": 0}
    return state


def frame(state: State, spans=None) -> np.ndarray:
    from shapegan_tpu_torch.render.raymarching import render_image

    f = state.cell.traffic["frame"]
    on_phase = None
    if spans is not None:
        phase = iter(PHASES)
        spans.begin("frame")
        spans.begin(next(phase))

        def on_phase(name):
            spans.end(name)
            following = next(phase, None)
            if following is not None:
                spans.begin(following)

    pixels = render_image(state.program.net, state.code, resolution=f["resolution"],
                          ssaa=f["ssaa"], iterations=f["iterations"], threshold=f["threshold"],
                          sdf_offset=f["sdf_offset"], radius=f["radius"],
                          color=tuple(f["color"]), on_phase=on_phase)
    if spans is not None:
        spans.end("frame")
    return pixels


def window(state: State, seconds: float, spans=None) -> dict:
    t0 = common.now(state.device)
    while not state.frames or time.perf_counter() - t0 < seconds:
        state.frames.append(frame(state, spans))
    window_s = common.now(state.device) - t0
    state.counts["frames"] = len(state.frames)
    return {"window_s": window_s, "units": len(state.frames),
            "metrics": {"frames_per_s": len(state.frames) / window_s}}


def work(state: State, check: dict) -> tuple:
    """The trace's and the frame's operations, from the evaluations that
    the reference's trace of the same rays needed: the trace's steps, and
    a forward and a backward (2 forwards) of each normal."""
    width = state.cell.config["width"]
    n = state.counts["frames"]
    trace = n * counts.trace_flops(state.needed["trace"], width)
    normals = n * 3 * counts.trace_flops(state.needed["normals"], width)
    return {"trace": (trace, 0)}, trace + normals


def release(state: State) -> None:
    state.program = None
    common.free(state.device)


NUMBERS = ("frame_mean_gap", "frame_pixels_unmatched", "frame_interior_unmatched")


def compare(got: np.ndarray, ref: np.ndarray, interior: np.ndarray, levels: int) -> Dict[str, float]:
    """Per frame: the mean gap in 8-bit levels over every channel of every
    pixel; and the share of pixels, of the whole frame and of the model's
    interior, that match no reference pixel of their 3 x 3 neighbourhood
    within ``levels`` in every channel (an edge that moved by a pixel
    still matches)."""
    if got.shape != ref.shape:
        return {k: float("inf") for k in NUMBERS}
    g, r = got.astype(np.int16), ref.astype(np.int16)
    padded = np.pad(r, ((1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = r.shape[:2]
    matched = np.zeros((h, w), dtype=bool)
    for dy in range(3):
        for dx in range(3):
            matched |= np.abs(g - padded[dy:dy + h, dx:dx + w]).max(axis=2) <= levels
    inside = float((~matched[interior]).mean()) if interior.any() else float("inf")
    return {"frame_mean_gap": float(np.abs(g - r).mean()),
            "frame_pixels_unmatched": float((~matched).mean()),
            "frame_interior_unmatched": inside}


def check(state: State, control: Optional[Precision] = None) -> Dict[str, float]:
    f = state.cell.traffic["frame"]
    settings = dict(f, camera=state.cell.config["camera"], light=state.cell.config["light"])
    block = state.cell.traffic["reference_block_rows"]
    levels = state.cell.traffic["pixel_levels"]
    with no_tf32():
        ref, needed = raymarch.render(state.params, state.code, settings, Precision.F32, block)
        interior = needed.pop("interior")
        frames = ([raymarch.render(state.params, state.code, settings, control, block)[0]]
                  if control is not None else state.frames)
    state.needed = needed
    # Frames of one chair are alike, bit for bit, unless something is off:
    # each distinct frame is compared once.
    distinct = {hashlib.sha256(f.tobytes()).digest(): f for f in frames}.values()
    numbers = {k: float("inf") for k in NUMBERS}
    for i, got in enumerate(distinct):
        one = compare(got, ref, interior, levels)
        numbers = one if i == 0 else {k: max(numbers[k], one[k]) for k in one}
    return numbers


def _fault_altered_answer():
    """Every frame comes back with a 32 x 32 block of its pixels inverted."""
    from shapegan_tpu_torch.render import raymarching

    inner = raymarching.render_image

    def altered(*args, **kwargs):
        pixels = inner(*args, **kwargs).copy()
        h, w = pixels.shape[0] // 2, pixels.shape[1] // 2
        pixels[h:h + 32, w:w + 32] = 255 - pixels[h:h + 32, w:w + 32]
        return pixels

    return common.patched(raymarching, "render_image", altered)


FAULTS = {"altered_answer": _fault_altered_answer}
CONTROLS = {"control": Precision.LOW}

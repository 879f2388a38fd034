"""Closed-loop generation requests, one in flight: each request is
``batch`` latents N(0, 1), drawn on the card from the seed, through
``train.hybrid_gan.generate_volumes_inference`` at the configuration's
resolution; it ends when its volumes are ready on the card (a
synchronize). Each request's latency is taken on the device's clock
(CUDA events around it: the card is idle when it is submitted).

The check compares a sample of the finished requests, drawn from the seed
as they finish (a reservoir), with the float32 reference."""

from __future__ import annotations

import random
import statistics
import time
import types
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from benchmark import counts, seeds
from benchmark.drivers import common
from benchmark.inputs import shapes, weights
from benchmark.reference import sdf_net
from benchmark.reference.precision import Precision, no_tf32


@dataclass
class State:
    cell: object
    device: torch.device
    g_init: dict
    pool: torch.Tensor
    program: Optional[types.SimpleNamespace] = None
    sample: List[tuple] = field(default_factory=list)   # (request, latents, volumes)
    counts: Dict[str, int] = field(default_factory=dict)
    latencies: List[float] = field(default_factory=list)


def setup(cell, seed: int, device) -> State:
    from shapegan_tpu_torch.models.sdf_net import SDFNet

    cfg, traffic = cell.config, cell.traffic
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    g_init = weights.draw(weights.sdf_net_spec(cfg["width"], cfg["latent_size"]), gen, device)
    requests = torch.Generator(device=device).manual_seed(seeds.derive(seed, "requests"))
    pool = torch.randn((traffic["latent_pool"], traffic["batch"], cfg["latent_size"]),
                       generator=requests, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    net = SDFNet(weights.clone(g_init), device=device)
    grid = shapes.voxel_grid(cfg["resolution"], device)
    state = State(cell, device, g_init, pool)
    state.program = types.SimpleNamespace(net=net, grid=grid, index=0,
                                          picks=random.Random(seeds.derive(seed, "sample")))
    for _ in range(traffic["warm_requests"]):
        request(state)
    common.sync(device)
    state.counts = {"requests": 0}
    state.latencies = []
    state.sample = []
    return state


def request(state: State, spans=None):
    """One request, timed as the span ``request`` when ``spans`` is given."""
    from shapegan_tpu_torch.train.hybrid_gan import generate_volumes_inference

    p, res = state.program, state.cell.config["resolution"]
    i = p.index
    z = state.pool[i % state.pool.shape[0]]
    if spans is not None:
        spans.begin("request")
    volumes = generate_volumes_inference(p.net, p.grid, z, res)
    if spans is not None:
        spans.end("request")
    common.sync(state.device)
    p.index += 1
    return i, z, volumes


def window(state: State, seconds: float, spans=None) -> dict:
    from benchmark.harness import Spans

    clock = spans or Spans(state.device)
    keep = state.cell.traffic["checked_requests"]
    picks = state.program.picks
    t0 = common.now(state.device)
    n = 0
    while n == 0 or time.perf_counter() - t0 < seconds:
        i, z, volumes = request(state, clock)
        n += 1
        # A uniform sample of the finished requests (reservoir sampling).
        if len(state.sample) < keep:
            state.sample.append((i, z, volumes))
        else:
            j = picks.randrange(n)
            if j < keep:
                state.sample[j] = (i, z, volumes)
    window_s = common.now(state.device) - t0
    state.latencies = clock.seconds("request")
    state.counts["requests"] = n
    batch = state.cell.traffic["batch"]
    p95 = statistics.quantiles(state.latencies, n=100, method="inclusive")[94]
    return {"window_s": window_s, "units": n,
            "metrics": {"volumes_per_s": n * batch / window_s, "generate_ms_p95": p95 * 1e3}}


def work(state: State, check: dict) -> tuple:
    cfg = state.cell.config
    fwd = counts.grid_forward(state.cell.traffic["batch"], cfg["resolution"] ** 3, cfg["width"],
                              cfg["latent_size"])
    n = state.counts["requests"]
    return {"grid_fwd": (n * fwd[0], n * fwd[1])}, n * fwd[0]


def release(state: State) -> None:
    state.program = None
    common.free(state.device)


def check(state: State, control: Optional[Precision] = None) -> Dict[str, float]:
    """The widest gap between a sampled request's volumes and the float32
    reference's, over the sample."""
    res = state.cell.config["resolution"]
    points = shapes.voxel_grid(res, state.device)
    block = state.cell.traffic["reference_block_points"]
    gap = 0.0 if state.sample else float("inf")
    with no_tf32():
        for _, z, volumes in state.sample:
            ref = sdf_net.grid(state.g_init, points, z, Precision.F32, block)
            got = (sdf_net.grid(state.g_init, points, z, control, block) if control is not None
                   else volumes.reshape(volumes.shape[0], -1))
            gap = max(gap, common.widest_gap(got, ref))
    return {"volume_gap": gap}


def _fault_altered_answer():
    """One volume of every request comes back with its sign flipped."""
    from shapegan_tpu_torch.train import hybrid_gan

    inner = hybrid_gan.generate_volumes_inference

    def altered(*args, **kwargs):
        volumes = inner(*args, **kwargs).clone()
        volumes[0] = -volumes[0]
        return volumes

    return common.patched(hybrid_gan, "generate_volumes_inference", altered)


FAULTS = {"altered_answer": _fault_altered_answer}
CONTROLS = {"control": Precision.LOW}

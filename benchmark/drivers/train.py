"""Closed-loop training of the progressive WGAN-GP, one batch at a time,
dispatched as ``train.hybrid_progressive_gan.train`` does: every batch a D
step on real volumes, fresh latents and penalty coefficients; every
``g_every``-th batch first a G step on fresh latents. The noise is drawn on
the card from the seed. The real batches come through the trainer's own
``train.common.ResidentBatches``. No saves, CSV, history or viewer.

Set-up drives the one training object through its first batches (the
record that the check compares), then the window goes on with it."""

from __future__ import annotations

import statistics
import time
import types
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from benchmark import counts, seeds
from benchmark.drivers import common
from benchmark.inputs import shapes, weights
from benchmark.reference import train_steps
from benchmark.reference.precision import Precision, no_tf32


@dataclass
class State:
    cell: object
    device: torch.device
    g_init: dict
    d_init: dict
    feed: List[dict] = field(default_factory=list)
    record: dict = field(default_factory=dict)
    program: Optional[types.SimpleNamespace] = None
    index: int = 0
    counts: Dict[str, int] = field(default_factory=dict)


def _sizes(cell):
    cfg = cell.config
    return cfg["batch_size"], cfg["latent_size"], cfg["resolution"]


def setup(cell, seed: int, device) -> State:
    from shapegan_tpu_torch.models.progressive_gan import ProgressiveDiscriminator
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer
    from shapegan_tpu_torch.train.common import ResidentBatches

    cfg = cell.config
    batch, latent, res = _sizes(cell)
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    g_init = weights.draw(weights.sdf_net_spec(cfg["width"], latent), gen, device)
    d_init = weights.draw(weights.critic_spec(**cfg["critic"]), gen, device)
    data = torch.Generator(device=device).manual_seed(seeds.derive(seed, "data"))
    volumes = shapes.make_volumes(cfg["dataset_shapes"], res, cfg["sdf_clipping"], data, device)
    batches = ResidentBatches(types.SimpleNamespace(array=volumes.cpu().numpy()), batch,
                              seeds.derive(seed, "shuffle"), device)
    del volumes
    common.free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    net = SDFNet(weights.clone(g_init), device=device)
    critic = ProgressiveDiscriminator(device=device)
    critic.load_state_dict(weights.clone(d_init))
    g_opt = RMSprop(net.param_dict(), cfg["learning_rate"])
    d_opt = RMSprop(dict(critic.named_parameters()), cfg["learning_rate"])
    g_step, d_step = trainer.make_steps(net, critic, g_opt, d_opt, cfg["iteration"])
    noise = torch.Generator(device=device).manual_seed(seeds.derive(seed, "noise"))
    state = State(cell, device, g_init, d_init)
    state.program = types.SimpleNamespace(net=net, critic=critic, g_opt=g_opt, d_opt=d_opt,
                                          g_step=g_step, d_step=d_step, batches=batches,
                                          epoch=0, iterator=None, noise=noise)
    batches.set_epoch(0)
    state.program.iterator = iter(batches)

    first = cell.traffic["checked_batches"]
    g_scores, d_scores = [], []
    state.program.g_step = _keeping_scores(g_step, critic, g_scores)
    state.program.d_step = _keeping_scores(d_step, critic, d_scores)
    for i in range(first):
        item = run_batch(state)
        state.feed.append({k: item[k] for k in ("z_g", "real", "z", "alpha") if k in item})
        metrics = item["metrics"]
        state.record.setdefault("d_losses", []).append(
            (metrics["pred_fake"] - metrics["pred_real"] + metrics["gradient_penalty"]).detach())
        if i == 0:
            state.program.g_step, state.program.d_step = g_step, d_step
            state.record["g_scores"] = _sorted(g_scores)
            state.record["d_scores"] = _sorted(d_scores)
            state.record["fake"] = item["fake"]
            state.record["g_nu"] = {k: v.clone() for k, v in g_opt.nu.items()}
            state.record["d_nu"] = {k: v.clone() for k, v in d_opt.nu.items()}
    state.record["g_params"] = weights.clone(net.param_dict())
    state.record["d_params"] = weights.clone(dict(critic.named_parameters()))
    while state.index < cell.traffic["warm_batches"]:
        run_batch(state)
    common.sync(device)
    state.counts = {"batches": 0, "g_steps": 0, "d_steps": 0}
    return state


def _keeping_scores(step, critic, scores: list):
    """The step as it is, with every score that the critic module returns
    inside it appended to ``scores``: one a row of each volume the critic
    sees (the G step's fakes; the D step's fakes, real volumes and penalty
    interpolates), the rows that its loss takes."""

    def kept(*args):
        handle = critic.register_forward_hook(
            lambda module, inputs, out: scores.append(out.detach().reshape(-1)))
        try:
            return step(*args)
        finally:
            handle.remove()

    return kept


def _sorted(scores: list) -> torch.Tensor:
    """The scores of one step, in ascending order: compared so, they do not
    depend on the order or the grouping of the critic's calls."""
    return torch.cat(scores).sort().values if scores else torch.empty(0)


def _next_real(program):
    try:
        return next(program.iterator)
    except StopIteration:
        program.epoch += 1
        program.batches.set_epoch(program.epoch)
        program.iterator = iter(program.batches)
        return next(program.iterator)


def run_batch(state: State, spans=None) -> dict:
    """One batch as the trainer runs it: the G step first every
    ``g_every``-th batch, then the D step; noise in the trainer's order."""
    p, cfg = state.program, state.cell.config
    batch, latent, _ = _sizes(state.cell)
    device, item = state.device, {}
    if state.index % cfg["g_every"] == 0:
        item["z_g"] = torch.randn((batch, latent), generator=p.noise, device=device)
        if spans:
            spans.begin("g_step")
        item["fake"] = p.g_step(item["z_g"], 1.0)
        if spans:
            spans.end("g_step")
        state.counts["g_steps"] = state.counts.get("g_steps", 0) + 1
    item["real"] = _next_real(p)
    item["z"] = torch.randn((batch, latent), generator=p.noise, device=device)
    item["alpha"] = torch.rand((batch, 1, 1, 1), generator=p.noise, device=device)
    if spans:
        spans.begin("d_step")
    item["metrics"] = p.d_step(item["real"], item["z"], item["alpha"], 1.0)
    if spans:
        spans.end("d_step")
    state.counts["d_steps"] = state.counts.get("d_steps", 0) + 1
    state.counts["batches"] = state.counts.get("batches", 0) + 1
    state.index += 1
    return item


def window(state: State, seconds: float, spans=None) -> dict:
    t0 = common.now(state.device)
    while not state.counts["batches"] or time.perf_counter() - t0 < seconds:
        run_batch(state, spans)
    window_s = common.now(state.device) - t0
    batch = state.cell.config["batch_size"]
    return {"window_s": window_s, "units": state.counts["batches"],
            "metrics": {"train_samples_per_s": state.counts["batches"] * batch / window_s}}


def work(state: State, check: dict) -> tuple:
    """(operations and bytes by operation, the model's operations) of the
    window's batches."""
    cfg = state.cell.config
    batch, latent, res = _sizes(state.cell)
    fwd = counts.grid_forward(batch, res ** 3, cfg["width"], latent)
    bwd = counts.grid_backward(batch, res ** 3, cfg["width"], latent)
    critic = counts.critic_forward_flops(cfg["critic"], res, cfg["iteration"], batch)
    g, d = state.counts["g_steps"], state.counts["d_steps"]
    model = d * (fwd[0] + counts.CRITIC_PASSES_D_STEP * critic) \
        + g * (fwd[0] + bwd[0] + counts.CRITIC_PASSES_G_STEP * critic)
    return {"grid_bwd": (g * bwd[0], g * bwd[1]),
            "grid_fwd": ((g + d) * fwd[0], (g + d) * fwd[1])}, model


def release(state: State) -> None:
    state.program = None
    common.free(state.device)


def _reference_cfg(cell) -> dict:
    cfg = cell.config
    return {"resolution": cfg["resolution"], "iteration": cfg["iteration"],
            "learning_rate": cfg["learning_rate"],
            "gradient_penalty_weight": cfg["gradient_penalty_weight"]}


def compare(got: dict, ref: dict, exclude_below: float) -> Dict[str, float]:
    """The numbers that decide ``correct`` (PERF.md, section 2). Each
    network's first gradient and its change over the checked batches are
    held leaf by leaf, by the median leaf's gap (``*_median_gap``); the worst
    leaf's (``*_worst_gap``) is printed beside it by calibrate.py."""
    out = {"fake_gap": common.widest_gap(got["fake"], ref["fake"])}
    losses = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
              for a, b in zip(got["d_losses"], ref["d_losses"])]
    out["d_loss_gap"] = max(losses) if len(losses) == len(ref["d_losses"]) else float("inf")
    # The critic's scores inside the first G and D steps, one a row: the
    # critic's arithmetic on inputs and weights alike on both sides (the
    # D step's real volumes), and every row that each loss takes.
    out["g_scores_gap"] = common.widest_gap(got["g_scores"], ref["g_scores"])
    out["d_scores_gap"] = common.widest_gap(got["d_scores"], ref["d_scores"])
    for net, init in (("g", "g_init"), ("d", "d_init")):
        # Each leaf's first gradient from RMSprop's state after one update,
        # nu = 0.1 g^2: |g| = sqrt(10 sum(nu)).
        norm_ref = {k: float((10.0 * v.double()).sum().sqrt()) for k, v in ref[f"{net}_nu"].items()}
        norm_got = {k: float((10.0 * v.double()).sum().sqrt()) for k, v in got[f"{net}_nu"].items()}
        out[f"{net}_grad_worst_gap"], out[f"{net}_grad_median_gap"] = \
            common.worst_and_median_gap(norm_got, norm_ref)
        # Leaves whose reference gradient is nought to rounding move by
        # round-off alone under RMSprop: they are left out of the change.
        median = statistics.median(norm_ref.values())
        keep = {k for k, v in norm_ref.items() if v >= exclude_below * median}
        start = ref[init]
        change_ref = common.norms({k: ref[f"{net}_params"][k] - start[k] for k in start})
        change_got = common.norms({k: got[f"{net}_params"][k] - start[k] for k in start})
        out[f"{net}_change_worst_gap"], out[f"{net}_change_median_gap"] = \
            common.worst_and_median_gap(change_got, change_ref, keep)
    return out


def check(state: State, control: Optional[Precision] = None) -> Dict[str, float]:
    """The program's record (or, for a control, the reference's in that
    lower precision) against the float32 reference's."""
    cell = state.cell
    points = shapes.voxel_grid(cell.config["resolution"], state.device)
    cfg = _reference_cfg(cell)
    block = cell.traffic["reference_block_points"]
    with no_tf32():
        ref = train_steps.follow(state.g_init, state.d_init, points, state.feed, cfg,
                                 Precision.F32, block)
        got = (train_steps.follow(state.g_init, state.d_init, points, state.feed, cfg,
                                  control, block) if control is not None else state.record)
    ref["g_init"], ref["d_init"] = state.g_init, state.d_init
    return compare(got, ref, cell.traffic["exclude_gradient_below"])


# Faults planted under the timed path; each must turn ``correct`` false.
def _fault_state_unchanged():
    from shapegan_tpu_torch import optim

    return common.patched(optim.RMSprop, "step", lambda self, grads: None)


def _fault_d_half_batch():
    """The D step trains on the first half of its rows, the mean taken over
    them; the G step is sound."""
    from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer

    make = trainer.make_steps

    def make_steps(*args, **kwargs):
        g_step, d_step = make(*args, **kwargs)

        def d_half(batch, z, alpha, fade):
            h = z.shape[0] // 2
            return d_step(batch[:h], z[:h], alpha[:h], fade)

        return g_step, d_half

    return common.patched(trainer, "make_steps", make_steps)


def _fault_g_half_batch():
    """The G step's loss is the mean over the first half of its fakes; all
    the fakes are made and returned."""
    from shapegan_tpu_torch.train import hybrid_progressive_gan as trainer

    def generator_grads(net, discriminator, grid, z, iteration, fade):
        params = net.param_dict()
        fake = trainer.generate_volumes(net, grid, z, trainer.RESOLUTIONS[iteration])
        loss = -discriminator(fake[: z.shape[0] // 2], iteration, fade).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        return dict(zip(params, grads)), fake.detach()

    return common.patched(trainer, "generator_grads", generator_grads)


FAULTS = {"state_unchanged": _fault_state_unchanged, "d_half_batch": _fault_d_half_batch,
          "g_half_batch": _fault_g_half_batch}
# The controls: the reference in the program's place, below the precision
# that the configuration states, for both networks and for the critic alone.
CONTROLS = {"control": Precision.LOW, "control_critic": Precision.CRITIC_LOW}

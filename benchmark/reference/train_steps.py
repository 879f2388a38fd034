"""The first batches of progressive WGAN-GP training, followed in plain
PyTorch from the same weights and inputs as the program: per batch a G
step every ``g_every`` batches (generator loss ``-mean(D(G(z)))``) and a D
step (``mean(D(G(z'))) - mean(D(x)) + GP``), each an RMSprop update with
optax's rule (``nu <- 0.1 g^2 + 0.9 nu``, ``p -= lr g / sqrt(nu + 1e-8)``).

The generator's volumes are evaluated in blocks of points, and its
gradient accumulated block by block from the critic's gradient of the
volumes, so the reference fits beside nothing else on the card."""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import critic as C
from benchmark.reference import sdf_net
from benchmark.reference.precision import Precision

RMS_DECAY, RMS_EPS = 0.9, 1e-8


def rmsprop(params, nu, grads, lr):
    with torch.no_grad():
        for k in params:
            nu[k] = (1.0 - RMS_DECAY) * grads[k] * grads[k] + RMS_DECAY * nu[k]
            params[k] -= lr * grads[k] * torch.rsqrt(nu[k] + RMS_EPS)


def _volumes(g_params, points, z, res, precision, block):
    return sdf_net.grid(g_params, points, z, precision, block).reshape(-1, res, res, res)


def g_step(g_params, d_params, g_nu, points, z, cfg, precision, block):
    """One generator update; returns the fake volumes it was taken on and
    the critic's scores of them, ascending."""
    res, it = cfg["resolution"], cfg["iteration"]
    fake = _volumes(g_params, points, z, res, precision, block).requires_grad_(True)
    scores = C.critic(d_params, fake, it, precision)
    loss = -scores.mean()
    (d_fake,) = torch.autograd.grad(loss, fake)
    d_fake = d_fake.reshape(z.shape[0], -1)
    leaves = {k: v.detach().requires_grad_(True) for k, v in g_params.items()}
    grads = {k: torch.zeros_like(v) for k, v in g_params.items()}
    for lo in range(0, points.shape[0], block):
        out = sdf_net.grid_block(leaves, points[lo:lo + block], z, precision)
        part = torch.autograd.grad(out, list(leaves.values()), d_fake[:, lo:lo + block])
        for k, g in zip(leaves, part):
            grads[k] += g
    rmsprop(g_params, g_nu, grads, cfg["learning_rate"])
    return fake.detach(), scores.detach().sort().values


def d_step(g_params, d_params, d_nu, points, real, z, alpha, cfg, precision, block):
    """One critic update; returns its loss and the critic's scores of every
    volume it saw (fakes, real volumes, penalty interpolates), ascending."""
    res, it = cfg["resolution"], cfg["iteration"]
    fake = _volumes(g_params, points, z, res, precision, block)
    leaves = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}

    seen = []

    def score(x):
        out = C.critic(leaves, x, it, precision)
        seen.append(out.detach())
        return out

    gp = C.gradient_penalty(score, alpha, real, fake, cfg["gradient_penalty_weight"])
    loss = score(fake).mean() - score(real).mean() + gp
    found = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    # Layers that this growth iteration does not use get a zero gradient.
    grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), found)}
    rmsprop(d_params, d_nu, grads, cfg["learning_rate"])
    return loss.detach(), torch.cat(seen).sort().values


def follow(g_init, d_init, points, feed: List[Dict[str, torch.Tensor]], cfg,
           precision: Precision = Precision.F32, block: int = 16384) -> dict:
    """The record that the check compares, from the batches ``feed`` (each
    ``{'z_g'?, 'real', 'z', 'alpha'}``): the fakes of the first G step, each
    D step's loss, the critic's scores inside the first G and D steps
    (ascending), the first gradient of each network as RMSprop holds it
    (``nu`` after its first update) and the weights after the last batch."""
    g = {k: v.detach().clone() for k, v in g_init.items()}
    d = {k: v.detach().clone() for k, v in d_init.items()}
    g_nu = {k: torch.zeros_like(v) for k, v in g.items()}
    d_nu = {k: torch.zeros_like(v) for k, v in d.items()}
    record = {"d_losses": []}
    for batch in feed:
        if "z_g" in batch:
            fake, scores = g_step(g, d, g_nu, points, batch["z_g"], cfg, precision, block)
            if "fake" not in record:
                record["fake"], record["g_scores"] = fake, scores
                record["g_nu"] = {k: v.clone() for k, v in g_nu.items()}
        loss, scores = d_step(g, d, d_nu, points, batch["real"], batch["z"], batch["alpha"],
                              cfg, precision, block)
        record["d_losses"].append(loss)
        if "d_nu" not in record:
            record["d_scores"] = scores
            record["d_nu"] = {k: v.clone() for k, v in d_nu.items()}
    record["g_params"], record["d_params"] = g, d
    return record

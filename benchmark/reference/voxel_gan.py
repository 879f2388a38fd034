"""The voxel GAN in plain PyTorch (marian42/shapegan ``model/gan.py`` and
``train_gan.py``, arXiv:2002.00349, as the JAX package trains it), and its
first batches of training followed from the same weights and inputs as
the program.

Generator: a latent z [B, 128] as [B, 128, 1, 1, 1] through
ConvTranspose3d 128->256 (k4, s1, p0: 4^3), 256->128, 128->64 and 64->1
(k4, s2, p1: 8^3, 16^3, 32^3); after each but the last flax's BatchNorm
(the batch's mean and biased variance, eps 1e-5; where the update is kept
the running statistics move by ``stat <- 0.9 stat + 0.1 batch_stat``)
and LeakyReLU 0.2; tanh at the end. Discriminator: Conv3d 1->64->128->256
(k4, s2, p1), each with LeakyReLU 0.2, then Conv3d 256->1 (k4, s1, p0) and
a sigmoid: one score a volume.

A batch: a G step on ``-mean(log(clip(D(G(z)), 1e-7, 1)))`` (Adam at the
generator's rate; its BatchNorm keeps this forward's statistics); fresh
fakes from the updated generator without gradients (batch statistics, the
update thrown away); a D update on their BCE toward 0, then another on the
real batch's BCE toward 1 (Adam at the discriminator's rate). The BCE
clips probabilities to [1e-7, 1 - 1e-7]. Adam is optax's: b1 0.9, b2
0.999, eps 1e-8 outside the square root, bias correction from a count
that starts at 0, in float32.

``Precision.F32`` is the reference; :func:`follow` turns TF32 off for
matmuls and cuDNN while it runs. Any other
precision is the control: every convolution of both networks with
bfloat16 operands and its result cast back to float32, as autocast to
bfloat16 would run them; BatchNorm, the activations, the losses and Adam
stay float32."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.inputs import weights
from benchmark.reference.precision import Precision, no_tf32

Params = Dict[str, torch.Tensor]
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def generator_spec(cfg: dict) -> weights.Spec:
    """(name, shape, fan_in) of the generator's transposed convolutions:
    weights (C_in, C_out, k, k, k), fan_in C_out k^3 (PyTorch's rule for a
    transposed convolution)."""
    g, k3 = cfg["generator"], cfg["generator"]["kernel"] ** 3
    spec: weights.Spec = []
    for i, (c_in, c_out) in enumerate(zip(g["channels"], g["channels"][1:])):
        spec += [(f"convt{i}.weight", (c_in, c_out) + (g["kernel"],) * 3, c_out * k3),
                 (f"convt{i}.bias", (c_out,), c_out * k3)]
    return spec


def discriminator_spec(cfg: dict) -> weights.Spec:
    """(name, shape, fan_in) of the discriminator's convolutions: weights
    (C_out, C_in, k, k, k), fan_in C_in k^3."""
    d, k3 = cfg["discriminator"], cfg["discriminator"]["kernel"] ** 3
    spec: weights.Spec = []
    for i, (c_in, c_out) in enumerate(zip(d["channels"], d["channels"][1:])):
        spec += [(f"conv{i}.weight", (c_out, c_in) + (d["kernel"],) * 3, c_in * k3),
                 (f"conv{i}.bias", (c_out,), c_in * k3)]
    return spec


def fresh_weights(cfg: dict, generator: torch.Generator, device) -> Tuple[Params, Params]:
    """(generator, discriminator) tensors keyed as the program's modules'
    state: convolutions U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from one draw a
    network; BatchNorm scale 1, bias 0, running mean 0 and variance 1."""
    g = weights.draw(generator_spec(cfg), generator, device)
    for i, c in enumerate(cfg["generator"]["channels"][1:-1]):
        g[f"bn{i}.scale"] = torch.ones(c, device=device)
        g[f"bn{i}.bias"] = torch.zeros(c, device=device)
        g[f"bn{i}.mean"] = torch.zeros(c, device=device)
        g[f"bn{i}.var"] = torch.ones(c, device=device)
    return g, weights.draw(discriminator_spec(cfg), generator, device)


def split_stats(g: Params) -> Tuple[Params, Params]:
    """(parameters, running statistics) of the generator's tensors."""
    stats = {k: v for k, v in g.items() if k.endswith((".mean", ".var"))}
    return {k: v for k, v in g.items() if k not in stats}, stats


def _conv(fn, x, w, b, precision: Precision, **kw):
    if precision is Precision.F32:
        return fn(x, w, b, **kw)
    return fn(x.bfloat16(), w.bfloat16(), b.bfloat16(), **kw).float()


def generator(p: Params, stats: Params, z: torch.Tensor, cfg: dict, precision: Precision,
              update_stats: bool) -> Tuple[torch.Tensor, Params]:
    """SDF volumes [B, r, r, r] of latents z [B, L] in train mode, and the
    running statistics after this forward (the given ones unless
    ``update_stats``)."""
    g = cfg["generator"]
    bn, slope = cfg["batch_norm"], cfg["leaky_relu_slope"]
    layers = len(g["channels"]) - 1
    x = z.reshape(z.shape[0], -1, 1, 1, 1)
    new = dict(stats)
    for i in range(layers):
        stride, padding = (g["first_stride"], g["first_padding"]) if i == 0 else (g["stride"],
                                                                                   g["padding"])
        x = _conv(F.conv_transpose3d, x, p[f"convt{i}.weight"], p[f"convt{i}.bias"], precision,
                  stride=stride, padding=padding)
        if i == layers - 1:
            break
        mean = x.mean(dim=(0, 2, 3, 4))
        centered = x - mean.reshape(1, -1, 1, 1, 1)
        var = (centered * centered).mean(dim=(0, 2, 3, 4))          # biased, as flax's
        x = centered * torch.rsqrt(var + bn["eps"]).reshape(1, -1, 1, 1, 1)
        x = x * p[f"bn{i}.scale"].reshape(1, -1, 1, 1, 1) + p[f"bn{i}.bias"].reshape(1, -1, 1, 1, 1)
        if update_stats:
            m = bn["momentum"]
            new[f"bn{i}.mean"] = m * stats[f"bn{i}.mean"] + (1.0 - m) * mean.detach()
            new[f"bn{i}.var"] = m * stats[f"bn{i}.var"] + (1.0 - m) * var.detach()
        x = F.leaky_relu(x, negative_slope=slope)
    return torch.tanh(x.squeeze(1)), new


def discriminator(p: Params, volumes: torch.Tensor, cfg: dict,
                  precision: Precision) -> torch.Tensor:
    """Scores [B] in (0, 1) of volumes [B, r, r, r]."""
    d, slope = cfg["discriminator"], cfg["leaky_relu_slope"]
    layers = len(d["channels"]) - 1
    x = volumes.reshape(volumes.shape[0], 1, *volumes.shape[1:])
    for i in range(layers):
        last = i == layers - 1
        x = _conv(F.conv3d, x, p[f"conv{i}.weight"], p[f"conv{i}.bias"], precision,
                  stride=d["last_stride"] if last else d["stride"],
                  padding=d["last_padding"] if last else d["padding"])
        if not last:
            x = F.leaky_relu(x, negative_slope=slope)
    return torch.sigmoid(x.reshape(x.shape[0]))


def bce(scores: torch.Tensor, target: float, clip: float) -> torch.Tensor:
    p = scores.clamp(clip, 1.0 - clip)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()


def adam(params: Params, state: dict, grads: Params, lr: float) -> None:
    """One update of optax's Adam, in place; ``state`` holds ``count``,
    ``mu`` and ``nu``."""
    state["count"] += 1
    t = state["count"]
    one = torch.ones((), dtype=torch.float32, device=next(iter(params.values())).device)
    c_mu, c_nu = 1.0 - (one * B1) ** t, 1.0 - (one * B2) ** t    # float32, as optax's
    with torch.no_grad():
        for k in params:
            state["mu"][k] = (1.0 - B1) * grads[k] + B1 * state["mu"][k]
            state["nu"][k] = (1.0 - B2) * (grads[k] * grads[k]) + B2 * state["nu"][k]
            update = (state["mu"][k] / c_mu) / (torch.sqrt(state["nu"][k] / c_nu) + ADAM_EPS)
            params[k] = params[k] - lr * update


def _grads(loss: torch.Tensor, leaves: Params) -> Params:
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _leaves(params: Params) -> Params:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _adam_state(params: Params) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def follow(g_init: Params, d_init: Params, feed: List[Dict[str, torch.Tensor]], cfg: dict,
           precision: Precision = Precision.F32) -> dict:
    """The record that the check compares, from the batches ``feed`` (each
    ``{'z_g', 'z_d', 'real'}``): the first G step's fakes and the
    discriminator's scores inside it, the scores inside the first D step
    (fakes, then real volumes), ascending; the gradients of the first
    batch's two D updates (``d_grads``: fakes, then real volumes); each
    network's Adam moments after the first batch (the generator updated
    once, the discriminator twice); the parameters, the generator's
    running statistics and each network's Adam state (``count``, ``mu``,
    ``nu``) after the last batch."""
    with no_tf32():
        return _follow(g_init, d_init, feed, cfg, precision)


def _follow(g_init, d_init, feed, cfg, precision) -> dict:
    g, stats = split_stats({k: v.detach().clone() for k, v in g_init.items()})
    d = {k: v.detach().clone() for k, v in d_init.items()}
    g_adam, d_adam = _adam_state(g), _adam_state(d)
    clip = cfg["bce_clip"]
    record: dict = {"d_grads": []}
    for batch in feed:
        leaves = _leaves(g)
        fake, new_stats = generator(leaves, stats, batch["z_g"], cfg, precision, True)
        scores = discriminator(d, fake, cfg, precision)
        grads = _grads(-torch.log(scores.clamp(clip, 1.0)).mean(), leaves)
        stats = new_stats
        adam(g, g_adam, grads, cfg["g_learning_rate"])
        first = "fake" not in record
        if first:
            record["fake"] = fake.detach()
            record["g_scores"] = scores.detach().sort().values
        with torch.no_grad():
            fake, _ = generator(g, stats, batch["z_d"], cfg, precision, False)
        seen = []
        for volumes, target in ((fake, 0.0), (batch["real"], 1.0)):
            leaves = _leaves(d)
            scores = discriminator(leaves, volumes, cfg, precision)
            seen.append(scores.detach())
            grads = _grads(bce(scores, target, clip), leaves)
            if first:
                record["d_grads"].append(grads)
            adam(d, d_adam, grads, cfg["d_learning_rate"])
        if first:
            record["d_scores"] = torch.cat(seen).sort().values
            for net, state in (("g", g_adam), ("d", d_adam)):
                record[f"{net}_mu"] = dict(state["mu"])
                record[f"{net}_nu"] = dict(state["nu"])
    record["g_params"], record["d_params"], record["g_stats"] = g, d, stats
    record["g_adam"], record["d_adam"] = g_adam, d_adam
    return record

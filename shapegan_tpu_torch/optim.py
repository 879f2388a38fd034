"""Optimizers with optax's semantics, as the JAX package's trainers use them.

:class:`RMSprop` (``optax.rmsprop(lr)``): ``nu <- 0.1 g^2 + 0.9 nu`` from
``nu = 0``, then ``p <- p - lr g / sqrt(nu + 1e-8)``: decay 0.9 and eps
INSIDE the square root, no bias correction, no momentum.
``torch.optim.RMSprop`` is another rule (alpha 0.99, eps outside the square
root). The state is ``nu``, saved in the optimizer sidecar under optax's
path (``<g|d>/0/nu/<param>``).

:class:`Adam` (``optax.adam(lr)``): b1 0.9, b2 0.999, eps 1e-8 outside the
square root, eps_root 0, bias correction from a step count that starts at
0. Dense over every tensor: a row of the latent table that is not in the
batch still moves with its moments. The state is ``count``, ``mu`` and
``nu``, saved under optax's paths (``<name>/0/count``, ``<name>/0/mu/...``).
"""

from __future__ import annotations

from typing import Dict

import torch

from shapegan_tpu_torch import tracing

DECAY = 0.9
EPS = 1e-8


class RMSprop:
    """Updates the given tensors in place from gradients keyed alike. Its
    moments are updated in place too, so a CUDA graph that captured a step
    reads and writes the same tensors on every replay."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float):
        self.params = params
        self.learning_rate = float(learning_rate)
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        for key, param in self.params.items():
            g = grads[key]
            nu = self.nu[key]
            torch.add((1.0 - DECAY) * (g * g), DECAY * nu, out=nu)
            param.add_((torch.rsqrt(nu + EPS) * g) * -self.learning_rate)

    def state(self) -> dict:
        """``{"nu"}``: optax's ``ScaleByRmsState`` field."""
        return {"nu": self.nu}

    def load_state(self, state: dict) -> None:
        """Copy ``state["nu"]`` into the moments in place."""
        with torch.no_grad():
            for key, nu in self.nu.items():
                nu.copy_(state["nu"][key])


class SGD:
    """``optax.sgd(lr)``: ``p <- p - lr g``, no state. The sharded checks use
    it where Adam's normalization would hide a gradient's scale."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float):
        self.params = params
        self.learning_rate = float(learning_rate)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        for key, param in self.params.items():
            param.add_(grads[key] * -self.learning_rate)


B1 = 0.9
B2 = 0.999


class Adam:
    """Updates the given tensors in place from gradients keyed alike. The
    step count is a tensor on the parameters' device, so a step never waits
    for the host. Each step adds the number of tensors it updates to the
    counter ``optim.adam_tensor_updates``."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float):
        self.params = params
        self.learning_rate = float(learning_rate)
        device = next(iter(params.values())).device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        tracing.count("optim.adam_tensor_updates", len(self.params))
        self.count += 1
        correction_mu = 1 - torch.pow(B1, self.count)  # float32, as optax's decay**count
        correction_nu = 1 - torch.pow(B2, self.count)
        for key, param in self.params.items():
            g = grads[key]
            mu = (1 - B1) * g + B1 * self.mu[key]
            nu = (1 - B2) * (g * g) + B2 * self.nu[key]
            self.mu[key], self.nu[key] = mu, nu
            update = (mu / correction_mu) / (torch.sqrt(nu / correction_nu) + EPS)
            param.add_(update * -self.learning_rate)

    def state(self) -> dict:
        """``{"count", "mu", "nu"}``: optax's ``ScaleByAdamState`` fields."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state(self, state: dict) -> None:
        self.count = state["count"].to(torch.int32)
        self.mu = dict(state["mu"])
        self.nu = dict(state["nu"])


def optimizer_tree(opt, layout=lambda tensors: tensors) -> tuple:
    """An optimizer's state under optax's paths, ``(ScaleByAdamState,
    EmptyState)`` or ``(ScaleByRmsState, EmptyState)`` (the empty state has
    no leaves): ``0/count``, ``0/mu/...``, ``0/nu/...``; its per-parameter
    tensors passed through ``layout``."""
    return ({k: layout(v) if isinstance(v, dict) else v for k, v in opt.state().items()},)


def load_optimizer_tree(opt, tree: tuple, layout=lambda tensors: tensors) -> None:
    """The inverse of :func:`optimizer_tree`: ``layout`` maps a stored
    per-parameter tree back to tensors keyed like the optimizer's."""
    opt.load_state({k: layout(v) if isinstance(v, dict) else v for k, v in tree[0].items()})

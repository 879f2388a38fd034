"""RMSprop with optax's semantics (counterpart of ``optax.rmsprop(lr)``, as
the JAX package's trainers use it).

``nu <- 0.1 g^2 + 0.9 nu`` from ``nu = 0``, then ``p <- p - lr g /
sqrt(nu + 1e-8)``: decay 0.9 and eps INSIDE the square root, no bias
correction, no momentum. ``torch.optim.RMSprop`` is another rule (alpha
0.99, eps outside the square root). The state is ``nu``, saved in the
optimizer sidecar under optax's path (``<g|d>/0/nu/<param>``).
"""

from __future__ import annotations

from typing import Dict

import torch

DECAY = 0.9
EPS = 1e-8


class RMSprop:
    """Updates the given tensors in place from gradients keyed alike."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float):
        self.params = params
        self.learning_rate = float(learning_rate)
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        for key, param in self.params.items():
            g = grads[key]
            nu = (1.0 - DECAY) * (g * g) + DECAY * self.nu[key]
            self.nu[key] = nu
            param.add_((torch.rsqrt(nu + EPS) * g) * -self.learning_rate)

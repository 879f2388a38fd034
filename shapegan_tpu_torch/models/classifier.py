"""3-D CNN voxel category classifier (counterpart of
:mod:`shapegan_tpu.models.classifier`).

Conv3d 1→12 (kernel 5, no padding) + ReLU + MaxPool 2 → Conv3d 12→16 +
ReLU + MaxPool 2 → Conv3d 16→32 + ReLU → flatten → Linear → softmax (or
the logits). A 32^3 volume leaves the convolutions as 1^3 x 32, so the
Linear takes 32 features. Layers carry flax's auto names ``Conv_0``..``Conv_2``
and ``Dense_0``; :func:`~shapegan_tpu_torch.models.flax_layers.to_jax`
converts them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shapegan_tpu_torch.models import torch_uniform_init_

CHANNELS = (1, 12, 16, 32)


class Classifier(nn.Module):
    """32^3 SDF volumes → class probabilities [B, label_count]."""

    def __init__(self, label_count: int, generator: Optional[torch.Generator] = None, device=None):
        """Weights and biases drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        (the JAX package's inits) with ``generator`` (seed 0 if none is
        given), then moved to ``device``."""
        super().__init__()
        for i, (c_in, c_out) in enumerate(zip(CHANNELS, CHANNELS[1:])):
            setattr(self, f"Conv_{i}", nn.Conv3d(c_in, c_out, kernel_size=5))
        self.Dense_0 = nn.Linear(CHANNELS[-1], label_count)
        generator = generator or torch.Generator().manual_seed(0)
        for layer in (self.Conv_0, self.Conv_1, self.Conv_2, self.Dense_0):
            torch_uniform_init_(layer, generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        """Volumes [B, 32, 32, 32] (or one [32, 32, 32])."""
        if x.ndim == 3:
            x = x[None]
        x = x.reshape(x.shape[0], 1, *x.shape[1:])
        x = F.max_pool3d(F.relu(self.Conv_0(x)), 2)
        x = F.max_pool3d(F.relu(self.Conv_1(x)), 2)
        x = F.relu(self.Conv_2(x))
        logits = self.Dense_0(x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1))  # channels-last
        return logits if return_logits else torch.softmax(logits, dim=1)

"""32^3 voxel (variational) autoencoder (counterpart of
:mod:`shapegan_tpu.models.autoencoder`).

Encoder: Conv3d 1→24→48→96 (kernel 4, stride 2, padding 1) and 96→256
(kernel 4, stride 1, no padding: 1^3), each followed by flax's BatchNorm
and LeakyReLU 0.2, flattened, Linear 256→128. The VAE adds BatchNorm +
LeakyReLU and the heads ``encode_mean`` and ``encode_log_variance``; in
train mode the code is ``mean + exp(log_variance / 2) * eps``, ``eps`` given
by the caller (the JAX package draws it inside from a key), in eval mode
``mean``. Decoder: Linear 128→256, BatchNorm + LeakyReLU, a [B, 256, 1, 1,
1] volume through ConvTranspose3d 256→96 (kernel 4, stride 1: 4^3) and
96→48→24→1 (kernel 4, stride 2, padding 1), BatchNorm + LeakyReLU after
each but the last → SDF volumes [B, 32, 32, 32]. Channel multiplier 24.

Layers carry the flax module's auto names through
:func:`~shapegan_tpu_torch.models.flax_layers.to_jax` (``enc_convs.0`` →
``enc_convs_0``, ``enc_bns_0``, ``enc_dense``, ``vae_bn``, ``dec_dense``,
``dec_bn_dense``, ``dec_convts_0``, ``dec_bns_0`` ...).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shapegan_tpu_torch import LATENT_CODE_SIZE
from shapegan_tpu_torch.models import torch_uniform_init_
from shapegan_tpu_torch.models.flax_layers import BatchNorm

AUTOENCODER_MODEL_COMPLEXITY_MULTIPLIER = 24
amcm = AUTOENCODER_MODEL_COMPLEXITY_MULTIPLIER


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class Autoencoder(nn.Module):
    """32^3 SDF volumes → latent codes [B, 128] → SDF volumes."""

    def __init__(self, is_variational: bool = True, latent_code_size: int = LATENT_CODE_SIZE,
                 generator: Optional[torch.Generator] = None, device=None):
        """Weights and biases drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        (fan_in = in_channels x 4^3 for a conv, out_channels x 4^3 for a
        transposed one, in_features for a Linear: the JAX package's inits)
        with ``generator`` (seed 0 if none is given), then moved to
        ``device``."""
        super().__init__()
        self.is_variational = is_variational
        self.latent_code_size = latent_code_size
        size = latent_code_size
        enc = (1, amcm, 2 * amcm, 4 * amcm, 2 * size)
        self.enc_convs = nn.ModuleList(
            nn.Conv3d(c_in, c_out, kernel_size=4, stride=2 if i < 3 else 1, padding=1 if i < 3 else 0)
            for i, (c_in, c_out) in enumerate(zip(enc, enc[1:])))
        self.enc_bns = nn.ModuleList(BatchNorm(c) for c in enc[1:])
        self.enc_dense = nn.Linear(2 * size, size)
        if is_variational:
            self.vae_bn = BatchNorm(size)
            self.encode_mean = nn.Linear(size, size)
            self.encode_log_variance = nn.Linear(size, size)
        self.dec_dense = nn.Linear(size, 2 * size)
        self.dec_bn_dense = BatchNorm(2 * size)
        dec = (2 * size, 4 * amcm, 2 * amcm, amcm, 1)
        self.dec_convts = nn.ModuleList(
            nn.ConvTranspose3d(c_in, c_out, kernel_size=4, stride=1 if i == 0 else 2,
                               padding=0 if i == 0 else 1)
            for i, (c_in, c_out) in enumerate(zip(dec, dec[1:])))
        self.dec_bns = nn.ModuleList(BatchNorm(c) for c in dec[1:-1])
        generator = generator or torch.Generator().manual_seed(0)
        for layer in self.modules():
            if isinstance(layer, (nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
                torch_uniform_init_(layer, generator)
        if device is not None:
            self.to(device)

    @property
    def checkpoint_name(self) -> str:
        base = f"autoencoder-{self.latent_code_size:d}"
        return ("variational-" + base) if self.is_variational else base

    def encode(self, x: torch.Tensor, train: bool = True, eps: Optional[torch.Tensor] = None,
               return_mean_and_log_variance: bool = False, update_stats: bool = True):
        """SDF volumes [B, 32, 32, 32] (or flat) → codes [B, 128]; the VAE's
        with ``(z, mean, log_variance)`` when asked for (``log_variance`` is
        None in eval mode unless asked for). Without ``eps`` the train-mode
        VAE draws it from torch's default generator."""
        x = x.reshape(-1, 1, 32, 32, 32)
        for conv, bn in zip(self.enc_convs, self.enc_bns):
            x = _lrelu(bn(conv(x), train, update_stats))
        x = self.enc_dense(x.reshape(x.shape[0], -1))
        if not self.is_variational:
            return x
        x = _lrelu(self.vae_bn(x, train, update_stats))
        mean = self.encode_mean(x)
        log_variance = None
        if train or return_mean_and_log_variance:
            log_variance = self.encode_log_variance(x)
        if train:
            if eps is None:
                eps = torch.randn_like(mean)
            z = mean + torch.exp(log_variance * 0.5) * eps
        else:
            z = mean
        if return_mean_and_log_variance:
            return z, mean, log_variance
        return z

    def decode(self, z: torch.Tensor, train: bool = True,
               update_stats: bool = True) -> torch.Tensor:
        """Codes [B, 128] (or one code [128]) → SDF volumes [B, 32, 32, 32]."""
        if z.ndim == 1:
            z = z[None, :]
        x = _lrelu(self.dec_bn_dense(self.dec_dense(z), train, update_stats))
        x = x.reshape(-1, 2 * self.latent_code_size, 1, 1, 1)
        for convt, bn in zip(self.dec_convts[:-1], self.dec_bns):
            x = _lrelu(bn(convt(x), train, update_stats))
        return self.dec_convts[-1](x).squeeze(1)

    def forward(self, x: torch.Tensor, train: bool = True, eps: Optional[torch.Tensor] = None,
                update_stats: bool = True):
        """The reconstruction; the VAE's with its ``(mean, log_variance)``."""
        if self.is_variational:
            z, mean, log_variance = self.encode(x, train, eps, True, update_stats)
            return self.decode(z, train, update_stats), mean, log_variance
        return self.decode(self.encode(x, train, update_stats=update_stats), train, update_stats)

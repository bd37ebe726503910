"""Mask-aware BatchNorm.

Counterpart of ``openseg3d_tpu/models/norm.py:17-67``. In eval it normalises
with the running statistics; in training (``nn.Module.training``) with the
batch statistics of the valid rows, in float32:
mean = E[x], var = max(E[x^2] - E[x]^2, 0), one pass over x, the biased
batch variance (not torch's unbiased one); without a mask plain mean and
biased var. Training also moves the running statistics,
new = momentum * old + (1 - momentum) * batch (the flax convention: torch's
BatchNorm momentum m is 1 - m here). Padded rows are zeroed either way.

The JAX package skips the running-statistics update while flax initialises
the model (``norm.py:54``); the port initialises without a forward pass
(``weights.init_weights`` / ``load_flax_variables``), so every training
forward updates them. The statistics are not all-reduced across GPUs yet
(the JAX package gets SyncBN from GSPMD; here it waits for multi-GPU).
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of [..., C] given mask [...].

    Parameters and buffers carry the flax names (scale, bias / mean, var) so
    that ``weights.load_flax_variables`` maps them one to one."""

    def __init__(self, num_features: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('mean', torch.zeros(num_features))
        self.register_buffer('var', torch.ones(num_features))

    def _batch_stats(self, x: torch.Tensor, mask: torch.Tensor | None):
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        if mask is None:
            return xf.mean(dim=axes), xf.var(dim=axes, unbiased=False)
        m = mask.float()[..., None]
        count = torch.clamp(m.sum(), min=1.0)
        xm = xf * m
        mean = xm.sum(dim=axes) / count
        ex2 = (xm * xf).sum(dim=axes) / count
        # torch.maximum, not clamp: at a tie (var exactly 0) its gradient is
        # split in half, as jnp.maximum's is
        var = torch.maximum(ex2 - mean.square(), torch.zeros_like(mean))
        return mean, var

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        dt = x.dtype
        if self.training:
            mean, var = self._batch_stats(x, mask)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        # statistics in float32, applied in the compute dtype, as in the JAX package
        y = (x - mean.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        y = y * self.scale.to(dt) + self.bias.to(dt)
        if mask is not None:
            y = torch.where(mask[..., None], y, 0)
        return y

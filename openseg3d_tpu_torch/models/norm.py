"""Mask-aware BatchNorm and LayerNorm.

Counterpart of ``openseg3d_tpu/models/norm.py``. In eval it normalises
with the running statistics; in training (``nn.Module.training``) with the
batch statistics of the valid rows, in float32:
mean = E[x], var = max(E[x^2] - E[x]^2, 0), one pass over x, the biased
batch variance (not torch's unbiased one); without a mask the two-pass
mean and biased var of jnp.mean and jnp.var. Training also moves the running statistics,
new = momentum * old + (1 - momentum) * batch (the flax convention: torch's
BatchNorm momentum m is 1 - m here). Padded rows are zeroed either way.

The JAX package skips the running-statistics update while flax initialises
the model (``norm.py:54``); the port initialises without a forward pass
(``weights.init_weights`` / ``load_flax_variables``), so every training
forward updates them. With a process group of more than one rank the sums
are all-reduced before the division (``parallel.dist.all_reduce_sum``,
differentiable), so the statistics are those of the global batch, as GSPMD
makes them in the JAX package, and the running statistics move alike on
every rank: BatchNorm is always cross-replica, as under SPMD.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.dist import all_reduce_sum


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
        c = x.shape[-1]
        if mask is None:
            # jnp.mean and jnp.var over the global batch: two passes
            s = all_reduce_sum(torch.cat([xf.sum(dim=axes), xf.new_full((1,), xf.numel() // c)]))
            mean = s[:c] / s[c]
            var = all_reduce_sum((xf - mean).square().sum(dim=axes)) / s[c]
            return mean, var
        m = mask.float()[..., None]
        xm = xf * m
        # one pass: the sums and the count in one vector (one all-reduce)
        s = all_reduce_sum(torch.cat([xm.sum(dim=axes), (xm * xf).sum(dim=axes),
                                      m.sum().reshape(1)]))
        count = torch.clamp(s[2 * c], min=1.0)
        mean = s[:c] / count
        ex2 = s[c:2 * c] / count
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


class MaskedLayerNorm(nn.Module):
    """Row-wise LayerNorm (flax ``nn.LayerNorm``, eps 1e-5, its leaves
    ``LayerNorm_0/scale`` and ``bias``); the mask only zeroes padded rows.
    Statistics and result in float32, as flax infers the result type from a
    float32 scale."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(num_features, eps=eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        ln = self.LayerNorm_0
        y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
        if mask is not None:
            y = torch.where(mask[..., None], y, 0)
        return y

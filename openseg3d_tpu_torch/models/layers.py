"""Shared model layers: point MLP stacks, VFE, squeeze-excite, spatial
attention.

Counterpart of ``openseg3d_tpu/models/layers.py``. Submodules carry the
names that flax gives their counterparts (``Dense_0``, ``MaskedBatchNorm_0``,
...), so that ``weights.load_flax_variables`` maps one parameter tree onto the
other by name.

Training follows ``nn.Module.training`` (the JAX package's ``train`` flag):
it switches every MaskedBatchNorm to batch statistics.

dtype rule of the JAX package (``Dense(dtype=x.dtype)``): parameters stay
float32 and each layer computes in its input's dtype (bfloat16 on the
production path, ``RUNTIME.COMPUTE_DTYPE``); ``dense`` does the cast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.scatter import segment_max, segment_mean
from ..ops.sparse_conv import Rulebook, apply_subm
from ..utils.profiling import span
from .norm import MaskedBatchNorm


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None = None):
    """flax ``nn.Dense(dtype=dtype)`` with float32 params: input and params
    cast to `dtype` (default: the input's), product in that dtype."""
    dt = x.dtype if dtype is None else dtype
    b = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), b)


def dropout(x: torch.Tensor, rate: float, rng: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: in training keep each element with probability
    1 - rate, scaled by 1 / (1 - rate); identity in eval or at rate 0."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, 0)


class LinearBNReLU(nn.Module):
    """Linear(bias=False) + BN (eps 1e-5, flax momentum 0.9, i.e. torch's
    BatchNorm1d default 0.1) + optional ReLU."""

    def __init__(self, in_features: int, features: int, act: bool = True,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.act = act
        self.Dense_0 = nn.Linear(in_features, features, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, eps=bn_eps, momentum=0.9)

    def forward(self, x, mask):
        x = self.MaskedBatchNorm_0(dense(self.Dense_0, x), mask)
        return F.relu(x) if self.act else x


class PointEncoder(nn.Module):
    """BN (flax momentum 0.9) -> (64, 128, 256) LinearBNReLU tower ->
    Linear(out)."""

    def __init__(self, in_features: int, out_features: int = 64,
                 hidden=(64, 128, 256)):
        super().__init__()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(in_features, eps=1e-5, momentum=0.9)
        dims = (in_features,) + tuple(hidden)
        for i in range(len(hidden)):
            setattr(self, f'LinearBNReLU_{i}', LinearBNReLU(dims[i], dims[i + 1]))
        self.num_hidden = len(hidden)
        self.Dense_0 = nn.Linear(dims[-1], out_features)

    def forward(self, points, mask):
        x = self.MaskedBatchNorm_0(points, mask)
        for i in range(self.num_hidden):
            x = getattr(self, f'LinearBNReLU_{i}')(x, mask)
        x = dense(self.Dense_0, x)
        return torch.where(mask[..., None], x, 0)


def _vfe(reduce, features: torch.Tensor, point_voxel_ids: torch.Tensor,
         num_voxels: int) -> torch.Tensor:
    """[B, P, C] point features reduced by sample-local voxel ids [B, P]
    (-1 = unassigned) into [B, num_voxels, C]; empty voxels give 0. The JAX
    package vmaps the segment reduction over samples; here each sample's ids
    are offset into one flat segment range."""
    b, p, c = features.shape
    ok = (point_voxel_ids >= 0) & (point_voxel_ids < num_voxels)
    offs = (torch.arange(b, device=features.device) * num_voxels)[:, None]
    flat_ids = torch.where(ok, point_voxel_ids.long() + offs, -1).reshape(-1)
    out = reduce(features.reshape(b * p, c), flat_ids, b * num_voxels)
    return out.reshape(b, num_voxels, c)


def vfe_max(features: torch.Tensor, point_voxel_ids: torch.Tensor,
            num_voxels: int) -> torch.Tensor:
    """Max-VFE (``VFE(reduce='max')``) of the single-sweep branch."""
    return _vfe(segment_max, features, point_voxel_ids, num_voxels)


def vfe_mean(features: torch.Tensor, point_voxel_ids: torch.Tensor,
             num_voxels: int) -> torch.Tensor:
    """Mean-VFE (``VFE(reduce='mean')``) of the multi-sweep branch: the sum
    of each voxel's rows over their count, in the features' dtype."""
    return _vfe(segment_mean, features, point_voxel_ids, num_voxels)


class FlattenSELayer(nn.Module):
    """Squeeze-excite whose squeeze is a per-sample masked mean over rows."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // reduction, bias=False)
        self.Dense_1 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x, mask):
        m = mask.to(x.dtype)[..., None]
        pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1)   # [B, C]
        s = torch.sigmoid(dense(self.Dense_1, F.relu(dense(self.Dense_0, pooled))))
        return x * s[:, None, :]


class SALayer(nn.Module):
    """Spatial attention (``layers.py:89-101``): a 27-tap submanifold conv to
    one channel over the stage's rulebook (``apply_subm``, with its
    gather-only backward), then a sigmoid gate on every channel. Its kernel
    [27, Cin, 1] is the flax leaf ``kernel``."""

    def __init__(self, channels: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, channels, 1))

    def forward(self, features, rulebook: Rulebook, mask):
        with span('sparse_conv'):
            gate = apply_subm(features, rulebook, self.kernel, mask,
                              compute_dtype=features.dtype)
        return features * torch.sigmoid(gate)

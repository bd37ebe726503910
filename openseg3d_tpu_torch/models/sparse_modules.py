"""Sparse conv building blocks.

Counterpart of ``openseg3d_tpu/models/sparse_modules.py``. Every module takes
precomputed rulebooks: structure is built once per stage and reused by every
conv at that stage. Training follows ``nn.Module.training`` (batch statistics
in every MaskedBatchNorm). Every conv runs ``ops.sparse_conv``'s
autograd Function, which, like the JAX package's custom VJPs, keeps only the
conv's inputs for the backward, never the gathered neighbour rows, and
gathers the cotangent through the transposed rulebook. SparseBasicBlock's
squeeze-excite option (SPNet's stages 3-4) is ported; its spatial-attention
option (``with_sa``) is used by no model and is not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_conv import Rulebook, apply_subm
from .layers import FlattenSELayer
from .norm import MaskedBatchNorm

# backbone norm: BatchNorm1d(eps=1e-3, momentum=0.01), flax momentum 0.99
# (``sparse_modules.py:19-21``)
BN = dict(eps=1e-3, momentum=0.99)


class SparseConv(nn.Module):
    """Bare 3^3 sparse conv over any rulebook; kernel [27, Cin, Cout] in the
    JAX package's raster (dz, dy, dx) layout."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, rulebook: Rulebook, out_mask):
        y = apply_subm(x, rulebook, self.kernel, out_mask, compute_dtype=x.dtype)
        if self.bias is not None:
            y = torch.where(out_mask[..., None], y + self.bias.to(y.dtype), 0)
        return y


class ConvModule(nn.Module):
    """conv + BN + ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.SparseConv_0 = SparseConv(in_features, features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, **BN)

    def forward(self, x, rulebook: Rulebook, out_mask):
        return F.relu(self.MaskedBatchNorm_0(self.SparseConv_0(x, rulebook, out_mask),
                                             out_mask))


class SparseBasicBlock(nn.Module):
    """conv-BN-ReLU-conv-BN [+SE] + residual + ReLU; convs carry a bias.
    with_se scales the second BN's output by a FlattenSELayer gate."""

    def __init__(self, planes: int, with_se: bool = False):
        super().__init__()
        self.SparseConv_0 = SparseConv(planes, planes, use_bias=True)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(planes, **BN)
        self.SparseConv_1 = SparseConv(planes, planes, use_bias=True)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(planes, **BN)
        self.FlattenSELayer_0 = FlattenSELayer(planes) if with_se else None

    def forward(self, x, rulebook: Rulebook, mask):
        out = F.relu(self.MaskedBatchNorm_0(self.SparseConv_0(x, rulebook, mask), mask))
        out = self.MaskedBatchNorm_1(self.SparseConv_1(out, rulebook, mask), mask)
        if self.FlattenSELayer_0 is not None:
            out = self.FlattenSELayer_0(out, mask)
        out = F.relu(out + x)
        return torch.where(mask[..., None], out, 0)


class UpBlock(nn.Module):
    """Decoder block: transform the lateral, concat with the bottom,
    bottleneck + channel-fold residual, then upsample (inverse rulebook) or
    stay (subm rulebook)."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.inplanes = inplanes
        self.SparseBasicBlock_0 = SparseBasicBlock(inplanes)
        self.ConvModule_0 = ConvModule(2 * inplanes, inplanes)
        self.ConvModule_1 = ConvModule(inplanes, planes)

    def forward(self, x_bottom, x_lateral, rulebook: Rulebook, mask,
                out_rulebook: Rulebook, out_mask):
        x_trans = self.SparseBasicBlock_0(x_lateral, rulebook, mask)
        x = torch.cat([x_bottom, x_trans], dim=-1)
        x_m = self.ConvModule_0(x, rulebook, mask)
        # channel reduction: fold 2*inplanes -> inplanes by summing pairs
        n, v, c2 = x.shape
        x_red = x.reshape(n, v, self.inplanes, c2 // self.inplanes).sum(dim=-1)
        return self.ConvModule_1(x_m + x_red, out_rulebook, out_mask)

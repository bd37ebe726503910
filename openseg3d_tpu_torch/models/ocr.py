"""Object-Contextual Representations at the UNet bottleneck.

Counterpart of ``openseg3d_tpu/models/ocr.py``: a subm 3^3 transform, a soft
class-region pooling (a softmax over the voxels of each sample, per class,
of the raw aux logits), then a voxel-to-region attention with key_channels,
batched over the padded [B, V, C] layout. The softmaxes run in float32;
``sim`` is cast back to the features' dtype before the second product, as
in the JAX package. Key and value project the B x num_classes region rows
with an all-true mask, so in training their BatchNorms take those rows'
batch statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_conv import Rulebook, apply_subm
from ..utils.profiling import span
from .layers import dense, dropout
from .norm import MaskedBatchNorm


class _ProjectBNReLU(nn.Module):
    """Linear(bias=False) + BN (eps 1e-5, flax momentum 0.9) + ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, eps=1e-5, momentum=0.9)

    def forward(self, x, mask):
        return F.relu(self.MaskedBatchNorm_0(dense(self.Dense_0, x), mask))


class OCRLayer(nn.Module):
    """forward(features, probs, rulebook, mask, rng) -> features: in_channels
    -> mid_channels -> class-context attention with key_channels -> back to
    in_channels. probs are the aux classifier's logits (no softmax)."""

    drop = 0.05

    def __init__(self, in_channels: int = 256, mid_channels: int = 128,
                 key_channels: int = 64):
        super().__init__()
        self.key_channels = key_channels
        self.transform_kernel = nn.Parameter(torch.zeros(27, in_channels, mid_channels))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(mid_channels, eps=1e-5, momentum=0.9)
        self._ProjectBNReLU_0 = _ProjectBNReLU(mid_channels, key_channels)    # query
        self._ProjectBNReLU_1 = _ProjectBNReLU(mid_channels, key_channels)    # key
        self._ProjectBNReLU_2 = _ProjectBNReLU(mid_channels, key_channels)    # value
        self._ProjectBNReLU_3 = _ProjectBNReLU(key_channels, mid_channels)    # bottleneck
        self._ProjectBNReLU_4 = _ProjectBNReLU(2 * mid_channels, in_channels)

    def forward(self, features, probs, rulebook: Rulebook, mask, rng=None):
        with span('sparse_conv'):
            feats = apply_subm(features, rulebook, self.transform_kernel, mask,
                               compute_dtype=features.dtype)
        feats = F.relu(self.MaskedBatchNorm_0(feats, mask))

        # soft class-region pooling: softmax over each sample's voxels per class
        logits = torch.where(mask[..., None], probs, -1e9)
        attn = torch.softmax(logits.float(), dim=1)                     # [B, V, K]
        context = torch.einsum('bvk,bvc->bkc', attn, feats.float()).to(feats.dtype)

        ones = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)
        query = self._ProjectBNReLU_0(feats, mask)                       # [B, V, kc]
        key = self._ProjectBNReLU_1(context, ones)                       # [B, K, kc]
        value = self._ProjectBNReLU_2(context, ones)                     # [B, K, kc]
        sim = torch.einsum('bvk,bck->bvc', query, key) * (self.key_channels ** -0.5)
        sim = torch.softmax(sim.float(), dim=-1).to(feats.dtype)
        ctx = torch.einsum('bvc,bck->bvk', sim, value)
        ctx = self._ProjectBNReLU_3(ctx, mask)

        out = self._ProjectBNReLU_4(torch.cat([ctx, feats], dim=-1), mask)
        out = dropout(out, self.drop, rng, self.training)
        return torch.where(mask[..., None], out, 0)

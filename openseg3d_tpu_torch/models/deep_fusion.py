"""DeepFusion: each point attends to the image features of its neighbours.

Counterpart of ``openseg3d_tpu/models/deep_fusion.py``: the query is the
point's fused lidar features, the keys and values are projections of the
precomputed per-point 2D-semantic features of its k nearest points (the
voxel-bucket k-NN on the model path, ``ops/knn.voxel_bucket_knn``; brute
force without voxel structure); neighbours whose image features are all zero
(no camera sees them) are masked out. Submodules carry the flax names
(``Dense_0``, ``kv_proj``, ``Dense_1``) for the weight bridge.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.knn import knn_query, voxel_bucket_knn
from ..ops.scatter import take_rows
from .layers import dense, dropout

HIDDEN = 32         # the attention's width
N_NEIGHBORS = 16    # neighbours each point attends to
ATTN_PDROP = 0.3    # attention dropout while training


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral(features)`` over the last axis, with the flax
    layout: kernel [in, *features], bias [*features], float32; computes in
    the input's dtype and flattens the features."""

    def __init__(self, in_features: int, features: tuple):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((in_features,) + tuple(features)))
        self.bias = nn.Parameter(torch.zeros(tuple(features)))

    def forward(self, x):
        dt = x.dtype
        w = self.kernel.to(dt).reshape(self.kernel.shape[0], -1)
        return x @ w + self.bias.to(dt).reshape(-1)


class DeepFusionBlock(nn.Module):
    """points_xyz [B, P, 3], point_mask [B, P], lidar_features [B, P, Cl]
    (compute dtype), image_features [B, P, Ci] float32 -> [B, P, Ci] in the
    compute dtype, zero where point_mask is False.

    The keys, values and each point's camera-validity flag are one packed
    [.., 2 hidden + 1] row, gathered once by the neighbour ids (-1 read as
    row 0 and masked). Masked logits take the finite -1e9, not -inf: a
    point with no valid neighbour (every padded row) then softmaxes to a
    finite uniform row, which is zeroed, and its backward stays finite.
    Attention dropout (attn_pdrop, training only) draws from the generator
    passed as rng. knn_kernel_size and knn_bucket_cap are the config's
    FUSION_KNN_KERNEL_SIZE and FUSION_KNN_BUCKET_CAP."""

    def __init__(self, lidar_channel: int, image_channel: int, knn_kernel_size: int,
                 knn_bucket_cap: int):
        super().__init__()
        self.attn_pdrop = ATTN_PDROP
        self.knn_kernel_size = knn_kernel_size
        self.knn_bucket_cap = knn_bucket_cap
        self.Dense_0 = nn.Linear(lidar_channel, HIDDEN)
        self.kv_proj = DenseGeneral(image_channel, (2, HIDDEN))
        self.Dense_1 = nn.Linear(HIDDEN, image_channel)

    def neighbours(self, points_xyz, point_mask, point_voxel_ids=None, voxel_coords=None,
                   spatial_shape=None):
        """[B, P, N_NEIGHBORS] int32 neighbour ids (-1 none)."""
        with torch.no_grad():
            if point_voxel_ids is not None:
                ids, _ = voxel_bucket_knn(N_NEIGHBORS, points_xyz, point_mask, point_mask,
                                          point_voxel_ids, voxel_coords, spatial_shape,
                                          bucket_cap=self.knn_bucket_cap,
                                          kernel_size=self.knn_kernel_size)
            else:
                ids, _ = knn_query(N_NEIGHBORS, points_xyz, points_xyz, point_mask,
                                   point_mask)
        return ids

    def forward(self, points_xyz, point_mask, lidar_features, image_features, rng=None,
                point_voxel_ids=None, voxel_coords=None, spatial_shape=None):
        dt = lidar_features.dtype
        hc = HIDDEN
        q = dense(self.Dense_0, lidar_features)
        kv = self.kv_proj(image_features.to(dt))
        img_valid = image_features.abs().sum(dim=-1) > 0
        packed = torch.cat([kv, img_valid[..., None].to(dt)], dim=-1)
        ids = self.neighbours(points_xyz.contiguous(), point_mask, point_voxel_ids,
                              voxel_coords, spatial_shape)
        b, p, k = ids.shape
        gathered = take_rows(packed, ids.clamp(min=0).reshape(b, p * k)) \
            .reshape(b, p, k, 2 * hc + 1)
        kn, vn = gathered[..., :hc], gathered[..., hc:2 * hc]
        attn = torch.einsum('bpc,bpkc->bpk', q, kn) / math.sqrt(hc)
        nb_valid = (gathered[..., 2 * hc] > 0.5) & (ids >= 0)
        attn = torch.where(nb_valid, attn, -1e9)
        attn = torch.softmax(attn, dim=-1)
        attn = torch.where(nb_valid.any(dim=-1, keepdim=True), attn, 0)
        attn = dropout(attn, self.attn_pdrop, rng, self.training)
        out = dense(self.Dense_1, torch.einsum('bpk,bpkc->bpc', attn, vn))
        return torch.where(point_mask[..., None], out, 0)

"""SPNet segmentor: point MLP || VFE -> SparseUnet -> fusion head.

Counterpart of ``openseg3d_tpu/models/segmentors/spnet.py``. Training
follows ``nn.Module.training``; its dropout (OCR and head) draws from the
``torch.Generator`` passed as ``rng``, which training requires.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.sparse_conv import SparseTensor
from ..backbones.sparse_unet import SparseUnet, build_unet_plans
from .common import ModelSpec, PointBranch, SegmentorHead, fuse_and_classify


class SPNet(nn.Module):
    def __init__(self, spec: ModelSpec, voxel_feature_channel: int = 64,
                 point_feature_channel: int = 64):
        super().__init__()
        if spec.use_image_feature:
            raise NotImplementedError('DeepFusion image features are not ported yet')
        self.spec = spec
        self.PointBranch_0 = PointBranch(spec, point_feature_channel)
        self.SparseUnet_0 = SparseUnet(self.PointBranch_0.voxel_channels,
                                       voxel_feature_channel, spec.num_classes)
        self.SegmentorHead_0 = SegmentorHead(
            point_feature_channel + voxel_feature_channel, spec.num_classes)

    def forward(self, batch, rng: torch.Generator | None = None):
        if self.training and rng is None:
            raise ValueError('a training forward needs a torch.Generator (rng) for '
                             'its dropout')
        spec = self.spec
        point_per, voxel_feats, cur_mask = self.PointBranch_0(batch)
        st = SparseTensor(features=voxel_feats, coords=batch['voxel_coords'],
                          spatial_shape=spec.spatial_shape)
        plans = build_unet_plans(st, spec.capacities)
        out = self.SparseUnet_0(voxel_feats, plans, rng)
        point_out = fuse_and_classify(batch, point_per, out['voxel_features'],
                                      cur_mask, self.SegmentorHead_0, rng)
        return {
            'point_out': point_out,
            'voxel_out': out['voxel_out'],
            'aux_voxel_out': out['aux_voxel_out'],
            'voxel_coords': batch['voxel_coords'],
            'voxel_mask': batch['voxel_mask'],
            'aux_voxel_coords': out['aux_voxel_coords'],
            'aux_voxel_mask': out['aux_voxel_mask'],
        }

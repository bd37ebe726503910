"""Segformer segmentor: point MLP || VFE -> PointTransformer -> fusion head.

Counterpart of ``openseg3d_tpu/models/segmentors/segformer.py``. Training
follows ``nn.Module.training``; its dropout and stochastic depth draw from
the ``torch.Generator`` passed as ``rng`` (the JAX package's ``dropout`` rng
stream), which training requires.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.sparse_conv import SparseTensor
from ...utils.profiling import span
from ..backbones.point_transformer import PointTransformer, build_window_plans
from ..backbones.sparse_unet import build_unet_plans
from .common import (ModelSpec, PointBranch, SegmentorHead, build_deep_fusion,
                     fuse_and_classify)


class Segformer(nn.Module):
    def __init__(self, spec: ModelSpec, voxel_feature_channel: int = 32,
                 point_feature_channel: int = 64):
        super().__init__()
        self.spec = spec
        self.PointBranch_0 = PointBranch(spec, point_feature_channel)
        self.PointTransformer_0 = PointTransformer(
            spec, self.PointBranch_0.voxel_channels, voxel_feature_channel)
        fusion_channel = point_feature_channel + voxel_feature_channel
        self.DeepFusionBlock_0 = build_deep_fusion(spec, fusion_channel)
        self.SegmentorHead_0 = SegmentorHead(
            fusion_channel + (spec.dim_image_feature if spec.use_image_feature else 0),
            spec.num_classes)

    def forward(self, batch, rng: torch.Generator | None = None):
        if self.training and rng is None:
            raise ValueError('a training forward needs a torch.Generator (rng) for '
                             'its dropout and stochastic depth')
        spec = self.spec
        with span('point_branch'):
            point_per, voxel_feats, cur_mask = self.PointBranch_0(batch)
        st = SparseTensor(features=voxel_feats, coords=batch['voxel_coords'],
                          spatial_shape=spec.spatial_shape)
        with span('structure'):
            with span('structure.rulebooks'):
                plans = build_unet_plans(st, spec.capacities)
            with span('structure.windows'):
                window_parts, _ = build_window_plans(plans, spec)
        with span('backbone'):
            out = self.PointTransformer_0(voxel_feats, plans, window_parts, rng)
        with span('head'):
            point_out = fuse_and_classify(spec, batch, point_per, out['voxel_features'],
                                          cur_mask, self.SegmentorHead_0,
                                          self.DeepFusionBlock_0, rng)
        return {
            'point_out': point_out,
            'voxel_out': out['voxel_out'],
            'aux_voxel_out': out['aux_voxel_out'],
            'voxel_coords': batch['voxel_coords'],
            'voxel_mask': batch['voxel_mask'],
            'aux_voxel_coords': out['aux_voxel_coords'],
            'aux_voxel_mask': out['aux_voxel_mask'],
        }

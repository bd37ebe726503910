"""Shared segmentor scaffold: model spec, point branch, fusion head.

Counterpart of ``openseg3d_tpu/models/segmentors/common.py``, whose module
imports JAX, so ``ModelSpec`` is redefined here from the same config. The
single-sweep max-VFE and the multi-sweep mean-VFE branches are ported;
DeepFusion (image features) raises until it is.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...config import ConfigDict, grid_size
from ...ops.scatter import voxel_to_point
from ..layers import (FlattenSELayer, LinearBNReLU, PointEncoder, dense, dropout, vfe_max,
                      vfe_mean)
from ..backbones.sparse_unet import stage_capacities


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model hyper-parameters derived from the config; the same fields
    as the JAX package's ModelSpec."""
    num_classes: int
    dim_point: int
    use_multi_sweeps: bool
    use_cylinder: bool
    use_image_feature: bool
    dim_image_feature: int
    spatial_shape: tuple          # (gz, gy, gx)
    capacities: tuple             # per-stage voxel capacities
    window_shape: tuple
    depths: tuple
    drop_path_rate: float
    batching_info: tuple
    window_bucket_fractions: tuple
    voxel_size: tuple
    point_cloud_range: tuple
    compute_dtype: str = 'float32'
    fusion_knn_kernel_size: int = 3
    fusion_knn_bucket_cap: int = 8
    scan_unroll: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @classmethod
    def from_config(cls, cfg: ConfigDict) -> 'ModelSpec':
        gx, gy, gz = grid_size(cfg)
        dim_point = cfg.DATASET.DIM_POINT + (2 if cfg.DATASET.USE_CYLINDER else 0)
        caps = stage_capacities(cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE,
                                cfg.RUNTIME.STAGE_CAPACITY_RATIOS)
        batching = tuple(
            tuple(sorted(((int(k), (int(v['max_tokens']),
                                    int(v['batching_range'][0]),
                                    int(v['batching_range'][1])))
                          for k, v in stage.items()), key=lambda t: t[0]))
            for stage in cfg.MODEL.BATCHING_INFO)
        return cls(
            num_classes=cfg.DATASET.NUM_CLASSES,
            dim_point=dim_point,
            use_multi_sweeps=cfg.DATASET.USE_MULTI_SWEEPS,
            use_cylinder=cfg.DATASET.USE_CYLINDER,
            use_image_feature=cfg.DATASET.USE_IMAGE_FEATURE,
            dim_image_feature=cfg.DATASET.DIM_IMAGE_FEATURE,
            spatial_shape=(gz, gy, gx),
            capacities=tuple(caps),
            window_shape=tuple(cfg.MODEL.WINDOW_SHAPE),
            depths=tuple(cfg.MODEL.DEPTHS),
            drop_path_rate=float(cfg.MODEL.DROP_PATH_RATE),
            batching_info=batching,
            window_bucket_fractions=tuple(
                tuple(f) if isinstance(f, (list, tuple)) else f
                for f in cfg.RUNTIME.WINDOW_BUCKET_FRACTIONS),
            voxel_size=tuple(cfg.DATASET.VOXEL_SIZE),
            point_cloud_range=tuple(cfg.DATASET.POINT_CLOUD_RANGE),
            compute_dtype=str(cfg.RUNTIME.COMPUTE_DTYPE),
            fusion_knn_kernel_size=int(cfg.MODEL.get('FUSION_KNN_KERNEL_SIZE', 3)),
            fusion_knn_bucket_cap=int(cfg.MODEL.get('FUSION_KNN_BUCKET_CAP', 8)),
            scan_unroll=bool(cfg.RUNTIME.get('SCAN_UNROLL', True)),
        )


class SegmentorHead(nn.Module):
    """Fusion encoder + SE residual + dropout (0.3, training only) + point
    classifier."""

    def __init__(self, in_channels: int, num_classes: int, fusion_channel: int = 64):
        super().__init__()
        self.drop = 0.3       # nn.Dropout(0.3) of the JAX head (common.py:102)
        self.LinearBNReLU_0 = LinearBNReLU(in_channels, 256)
        self.LinearBNReLU_1 = LinearBNReLU(256, 128)
        self.LinearBNReLU_2 = LinearBNReLU(128, fusion_channel)
        self.FlattenSELayer_0 = FlattenSELayer(fusion_channel)
        self.LinearBNReLU_3 = LinearBNReLU(fusion_channel, 64)
        self.Dense_0 = nn.Linear(64, num_classes, bias=False)

    def forward(self, point_fusion_features, cur_mask, rng=None):
        x = self.LinearBNReLU_0(point_fusion_features, cur_mask)
        x = self.LinearBNReLU_1(x, cur_mask)
        x = self.LinearBNReLU_2(x, cur_mask)
        x = x + self.FlattenSELayer_0(x, cur_mask)
        x = self.LinearBNReLU_3(x, cur_mask)
        x = dropout(x, self.drop, rng, self.training)
        # classifier logits in float32 (loss/metric numerics)
        point_out = dense(self.Dense_0, x, torch.float32)
        return torch.where(cur_mask[..., None], point_out, 0)


class PointBranch(nn.Module):
    """Point MLP + VFE voxelization, the preamble of both segmentors.

    Single sweep: the max over each voxel's current points of their encoded
    features. Multi-sweep: the mean of the raw points of every sweep
    (``point_mask``, history included), in float32, then cast to the compute
    dtype; the backbone's stem then takes ``dim_point`` channels
    (``voxel_channels``)."""

    def __init__(self, spec: ModelSpec, point_feature_channel: int = 64):
        super().__init__()
        self.spec = spec
        self.PointEncoder_0 = PointEncoder(spec.dim_point, point_feature_channel)
        self.voxel_channels = spec.dim_point if spec.use_multi_sweeps else point_feature_channel

    def forward(self, batch):
        points = batch['points']
        point_mask = batch['point_mask']
        cur_mask = batch['cur_point_mask'] & point_mask
        vids = batch['point_voxel_ids']           # sample-local slots
        v_cap = batch['voxel_coords'].shape[1]
        dt = self.spec.dtype
        # compute dtype boundary: everything downstream runs in
        # RUNTIME.COMPUTE_DTYPE; params stay float32
        point_per_features = self.PointEncoder_0(points.to(dt), cur_mask)
        if self.spec.use_multi_sweeps:
            src = torch.where(point_mask[..., None], points, 0)
            voxel_features = vfe_mean(src, torch.where(point_mask, vids, -1), v_cap).to(dt)
        else:
            voxel_features = vfe_max(point_per_features, torch.where(cur_mask, vids, -1), v_cap)
        return point_per_features, voxel_features, cur_mask


def fuse_and_classify(batch, point_per_features, voxel_features, cur_mask,
                      head: SegmentorHead, rng=None):
    """Devoxelize + head."""
    pvf = voxel_to_point(voxel_features, batch['point_voxel_ids'])
    return head(torch.cat([point_per_features, pvf], dim=-1), cur_mask, rng)

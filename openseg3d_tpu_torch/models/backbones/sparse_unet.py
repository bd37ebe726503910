"""Sparse-conv UNet backbone (SPNet's) and the per-stage structure of the
4-stage UNet topology that both backbones share.

Counterpart of ``openseg3d_tpu/models/backbones/sparse_unet.py``: a subm 3^3
stem, four encoder stages (channels 32/64/128/256) of SparseBasicBlocks
behind stride-2 downsamples, squeeze-excite on the last block of stages 3-4,
an aux classifier and OCR at the bottleneck, an UpBlock decoder on inverse
convs, and the voxel classifier. The JAX package builds the subm structure
with its planar fast path (``build_planar_k3_direct``); the port builds the
general rulebook, whose neighbour sets are the same (``ops/sparse_conv``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ...ops.sparse_conv import SparseTensor, build_downsample, build_subm_rulebook
from ..layers import dense
from ..ocr import OCRLayer
from ..sparse_modules import ConvModule, SparseBasicBlock, UpBlock


def _round128(x: float) -> int:
    return max(128, int(-(-x // 128) * 128))


def stage_capacities(max_voxels: int, ratios) -> list[int]:
    return [_round128(max_voxels * r) for r in ratios]


class UNetPlans(NamedTuple):
    """All per-stage structure for a 4-stage UNet over one voxel set."""
    masks: tuple          # stage validity masks [B, V_s]
    coords: tuple         # stage coords [B, V_s, 3]
    subm: tuple           # stage submanifold rulebooks
    down: tuple           # DownsamplePlan for stages 2..4 (len 3)
    shapes: tuple         # spatial shapes per stage


def build_unet_plans(st: SparseTensor, capacities) -> UNetPlans:
    """Rulebooks for 4 stages with stride-2 / kernel-3 / pad-1 downsamples
    between them. Stage coords are in ascending key order (the voxelizer
    emits sorted slots, downsample outputs are sorted by construction)."""
    masks, coords, subm, downs, shapes = [], [], [], [], []
    cur = st
    for s in range(4):
        masks.append(cur.mask)
        coords.append(cur.coords)
        shapes.append(cur.spatial_shape)
        subm.append(build_subm_rulebook(cur))
        if s < 3:
            plan = build_downsample(cur, out_capacity=capacities[s + 1],
                                    kernel_size=3, stride=2, padding=1)
            downs.append(plan)
            cur = SparseTensor(features=None, coords=plan.out_coords,
                               spatial_shape=plan.out_shape)
    return UNetPlans(masks=tuple(masks), coords=tuple(coords), subm=tuple(subm),
                     down=tuple(downs), shapes=tuple(shapes))


class SparseUnet(nn.Module):
    """forward(features, plans, rng) -> dict with voxel_features, voxel_out,
    aux_voxel_out and the stage-4 coords and mask for the aux loss."""

    def __init__(self, in_channels: int, output_channels: int, num_classes: int):
        super().__init__()
        chans = (32, 64, 128, 256)
        prev, block = in_channels, 0
        for s, c in enumerate(chans):
            # stage s: the stem (s = 0) or a downsample, then its blocks, the
            # last block of stages 3-4 with squeeze-excite
            setattr(self, f'ConvModule_{s}', ConvModule(prev, c))
            n = 2 if s == 0 else 3
            for i in range(n):
                setattr(self, f'SparseBasicBlock_{block}',
                        SparseBasicBlock(c, with_se=s >= 2 and i == n - 1))
                block += 1
            prev = c
        self.aux_voxel_classifier = nn.Linear(256, num_classes, bias=False)
        self.OCRLayer_0 = OCRLayer(256, 128, 64)
        self.UpBlock_0 = UpBlock(256, 128)
        self.UpBlock_1 = UpBlock(128, 64)
        self.UpBlock_2 = UpBlock(64, 32)
        self.UpBlock_3 = UpBlock(32, output_channels)
        self.voxel_classifier = nn.Linear(output_channels, num_classes, bias=False)

    def forward(self, voxel_features, plans: UNetPlans, rng=None):
        m1, m2, m3, m4 = plans.masks
        rb1, rb2, rb3, rb4 = plans.subm
        d2, d3, d4 = plans.down
        rules = (rb1, d2.rule, d3.rule, d4.rule)
        masks = (m1, m2, m3, m4)

        x, skips, block = voxel_features, [], 0
        for s in range(4):
            x = getattr(self, f'ConvModule_{s}')(x, rules[s], masks[s])
            for _ in range(2 if s == 0 else 3):
                x = getattr(self, f'SparseBasicBlock_{block}')(x, plans.subm[s], masks[s])
                block += 1
            skips.append(x)
        x_conv1, x_conv2, x_conv3, x_conv4 = skips

        # classifiers compute in float32 (Dense(dtype=float32) in the JAX package)
        aux_voxel_out = dense(self.aux_voxel_classifier, x_conv4, torch.float32)
        x_conv4 = self.OCRLayer_0(x_conv4, aux_voxel_out, rb4, m4, rng)

        # decoder: up4 self-skips, the last block stays on the stage-1 subm
        x = self.UpBlock_0(x_conv4, x_conv4, rb4, m4, d4.inv_rule, m3)
        x = self.UpBlock_1(x, x_conv3, rb3, m3, d3.inv_rule, m2)
        x = self.UpBlock_2(x, x_conv2, rb2, m2, d2.inv_rule, m1)
        x = self.UpBlock_3(x, x_conv1, rb1, m1, rb1, m1)

        voxel_out = dense(self.voxel_classifier, x, torch.float32)
        return {
            'voxel_features': x,
            'voxel_out': voxel_out,
            'aux_voxel_out': aux_voxel_out,
            'aux_voxel_coords': plans.coords[3],
            'aux_voxel_mask': m4,
        }

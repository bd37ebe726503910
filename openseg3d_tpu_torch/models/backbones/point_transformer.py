"""SWFormer-style window-transformer backbone.

Counterpart of ``openseg3d_tpu/models/backbones/point_transformer.py``: a
submanifold-conv stem, 4 stages of dual-shift window partition + SWFormer
blocks (channels 48/96/192/384, 8 heads), strided sparse-conv downsamples, an
UpBlock decoder on inverse convs, and an aux head at the bottleneck. Dropped
voxels keep their slots with zeroed features. Stochastic depth rates rise
linearly over all encoder layers, ``np.linspace(0, DROP_PATH_RATE,
sum(depths))`` split by stage (``point_transformer.py:58-67``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.window import batched_window_partition, make_level_specs
from ..layers import dense
from ..sparse_modules import ConvModule, UpBlock
from ..swformer import SWFormerBlock
from .sparse_unet import UNetPlans

CHANNELS = (48, 96, 192, 384)
NHEAD = 8


def stage_level_specs(spec) -> tuple:
    """Static window levels of the 4 stages (spec: ModelSpec)."""
    return tuple(make_level_specs(spec.batching_info[s], spec.capacities[s],
                                  spec.window_bucket_fractions[s]) for s in range(4))


def build_window_plans(plans: UNetPlans, spec):
    """Dual-shift window partitions for all 4 stages (structure only)."""
    level_specs = stage_level_specs(spec)
    parts = tuple(batched_window_partition(plans.coords[s], plans.masks[s],
                                           plans.shapes[s], spec.window_shape,
                                           level_specs[s]) for s in range(4))
    return parts, level_specs


class PointTransformer(nn.Module):
    def __init__(self, spec, in_channels: int = 64, output_channels: int = 32):
        super().__init__()
        levels = stage_level_specs(spec)
        chans = (in_channels,) + CHANNELS
        dpr = np.linspace(0, spec.drop_path_rate, sum(spec.depths)).tolist()
        bounds = np.cumsum((0,) + tuple(spec.depths)).tolist()
        for s in range(4):
            # conv_input, conv_down1..3
            setattr(self, f'ConvModule_{s}', ConvModule(chans[s], chans[s + 1]))
            setattr(self, f'SWFormerBlock_{s}', SWFormerBlock(
                CHANNELS[s], NHEAD, spec.depths[s], spec.window_shape, levels[s],
                drop_path=tuple(dpr[bounds[s]:bounds[s + 1]])))
        self.aux_voxel_classifier = nn.Linear(CHANNELS[3], spec.num_classes, bias=False)
        self.UpBlock_0 = UpBlock(384, 192)
        self.UpBlock_1 = UpBlock(192, 96)
        self.UpBlock_2 = UpBlock(96, 48)
        self.UpBlock_3 = UpBlock(48, output_channels)
        self.voxel_classifier = nn.Linear(output_channels, spec.num_classes, bias=False)

    def forward(self, voxel_features, plans: UNetPlans, window_parts, rng=None):
        m1, m2, m3, m4 = plans.masks
        rb1, rb2, rb3, rb4 = plans.subm
        d2, d3, d4 = plans.down
        rules = (rb1, d2.rule, d3.rule, d4.rule)
        masks = (m1, m2, m3, m4)

        x, skips = voxel_features, []
        for s in range(4):
            x = getattr(self, f'ConvModule_{s}')(x, rules[s], masks[s])
            x = getattr(self, f'SWFormerBlock_{s}')(x, window_parts[s], rng)
            skips.append(x)
        x_conv1, x_conv2, x_conv3, x_conv4 = skips

        # classifiers compute in float32 (Dense(dtype=float32) in the JAX package)
        aux_voxel_out = dense(self.aux_voxel_classifier, x_conv4, torch.float32)

        # decoder; up4 self-skips
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

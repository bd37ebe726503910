"""Point-cloud coordinate utilities.

Counterpart of ``openseg3d_tpu/utils/pointops.py:16-22`` (the part the train
step uses). ``query_and_group`` and ``interpolation`` are off the main path
and not ported yet.
"""

from __future__ import annotations

import torch


def get_voxel_centers(voxel_coords: torch.Tensor, downsample_scale: float,
                      voxel_size, point_cloud_range) -> torch.Tensor:
    """zyx int coords [..., 3] -> xyz float32 centres,
    (xyz + 0.5) * voxel_size * downsample_scale + range origin. Padding rows
    (coords -1) give meaningless centres: mask them downstream."""
    xyz = voxel_coords.flip(-1).float()
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=xyz.device) * downsample_scale
    origin = torch.tensor(point_cloud_range[0:3], dtype=torch.float32, device=xyz.device)
    return (xyz + 0.5) * vs + origin

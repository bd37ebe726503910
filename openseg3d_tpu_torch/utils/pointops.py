"""Point-cloud coordinate utilities.

Counterpart of ``openseg3d_tpu/utils/pointops.py:9-22``: ``cart2polar``
(numpy, for the datasets' cylinder layout) and ``get_voxel_centers`` (the
train step's aux labels). ``query_and_group`` and ``interpolation`` are off
the main path and not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def cart2polar(points: np.ndarray) -> np.ndarray:
    """Cartesian xyz -> (rho, phi, z); numpy, host side."""
    rho = np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2)
    phi = np.arctan2(points[:, 1], points[:, 0])
    return np.stack((rho, phi, points[:, 2]), axis=1)


def get_voxel_centers(voxel_coords: torch.Tensor, downsample_scale: float,
                      voxel_size, point_cloud_range) -> torch.Tensor:
    """zyx int coords [..., 3] -> xyz float32 centres,
    (xyz + 0.5) * voxel_size * downsample_scale + range origin. Padding rows
    (coords -1) give meaningless centres: mask them downstream."""
    xyz = voxel_coords.flip(-1).float()
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=xyz.device) * downsample_scale
    origin = torch.tensor(point_cloud_range[0:3], dtype=torch.float32, device=xyz.device)
    return (xyz + 0.5) * vs + origin

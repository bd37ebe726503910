"""Point-cloud coordinate utilities.

Counterpart of ``openseg3d_tpu/utils/pointops.py``: ``cart2polar`` (numpy,
for the datasets' cylinder layout), ``get_voxel_centers`` (the train step's
aux labels), and the k-NN grouping and inverse-distance interpolation of
the reference's point ops (``query_and_group``, ``interpolation``; no model
calls them), on ``ops/knn.knn_query``.
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


def query_and_group(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor | None,
                    feat: torch.Tensor, idx: torch.Tensor | None = None,
                    p_valid: torch.Tensor | None = None, q_valid: torch.Tensor | None = None,
                    use_xyz: bool = True) -> torch.Tensor:
    """For each query, its nsample nearest source points' features, with the
    neighbours' xyz re-centred on the query (``pointops.py:25-52``). Validity
    masks stand in for the reference's batch offsets; a neighbour slot with
    idx -1 gives zeros. xyz [P, 3], new_xyz [Q, 3] (None: xyz), feat [P, C]
    -> [Q, nsample, 3 + C] ([Q, nsample, C] without use_xyz)."""
    if new_xyz is None:
        new_xyz, q_valid = xyz, p_valid
    if idx is None:
        from ..ops.knn import knn_query
        pv = p_valid if p_valid is not None else torch.ones(xyz.shape[0], dtype=torch.bool,
                                                            device=xyz.device)
        qv = q_valid if q_valid is not None else torch.ones(new_xyz.shape[0], dtype=torch.bool,
                                                            device=xyz.device)
        idx = knn_query(nsample, xyz[None], new_xyz[None], pv[None], qv[None])[0][0]
    safe = idx.clamp(min=0).long()
    ok = (idx >= 0)[..., None]
    grouped_feat = torch.where(ok, feat[safe], 0)
    if not use_xyz:
        return grouped_feat
    grouped_xyz = torch.where(ok, xyz[safe] - new_xyz[:, None, :], 0)
    return torch.cat([grouped_xyz, grouped_feat], dim=-1)


def interpolation(idx: torch.Tensor, dist: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted k-NN interpolation (``pointops.py:55-63``):
    idx [Q, k] into feat [P, C], dist [Q, k] -> [Q, C]; a slot with idx -1
    adds nothing but keeps its weight in the normaliser, as in the JAX
    package."""
    w = 1.0 / (dist + 1e-8)
    w = w / w.sum(dim=1, keepdim=True)
    g = torch.where((idx >= 0)[..., None], feat[idx.clamp(min=0).long()], 0)
    return (g * w[..., None]).sum(dim=1)

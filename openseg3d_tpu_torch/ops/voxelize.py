"""Voxelization on the device, for test-time augmentation.

Counterpart of ``openseg3d_tpu/ops/voxelize.py``: the host voxelizer's
semantics (``core/voxelizer.py``: floor binning, strict [0, grid) bounds,
zyx coords in ascending z-major key order, id -1 out of range) from one key
sort and a cumulative sum, so that every TTA variant is transformed and
voxelized where the model runs and the host touches a frame once. Keys are
int32, as in the reference, with ``INT32_SENTINEL`` for points that are
masked or out of range, so that those sort last. Plain PyTorch on either
device; the result does not depend on the sort's stability (points of one
voxel share its key), so the card and the CPU give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse_conv import INT32_SENTINEL, delinearize


def device_voxelize(points: torch.Tensor, pmask: torch.Tensor, voxel_size, pc_range,
                    max_voxels: int):
    """points [B, P, >=3] float32 (x, y, z, ...), pmask [B, P] bool ->
    (voxel_coords [B, max_voxels, 3] int32 zyx (-1 past the voxels),
    voxel_mask [B, max_voxels], point_voxel_ids [B, P] int32 (-1 for a point
    that is masked, out of range or in a voxel past max_voxels), num_voxels
    [B] int32, the count before the cap)."""
    b, p = pmask.shape
    dev = points.device
    rng = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    gx, gy, gz = (int(g) for g in np.round((rng[3:] - rng[:3]) / vs))   # as the host rounds it
    lo = torch.tensor(rng[:3], device=dev)
    vs = torch.tensor(vs, device=dev)
    grid = torch.tensor([gx, gy, gz], dtype=torch.float32, device=dev)
    # bounds on the floored floats: an out-of-range float never reaches the
    # int32 cast, whose result for it would differ between devices
    f = torch.floor((points[..., :3] - lo) / vs)
    ok = pmask & ((f >= 0) & (f < grid)).all(dim=-1)
    c = torch.where(ok[..., None], f, 0).int()
    key = (c[..., 2] * gy + c[..., 1]) * gx + c[..., 0]
    keys, order = torch.sort(torch.where(ok, key, INT32_SENTINEL), dim=1)
    valid_s = keys != INT32_SENTINEL
    is_new = torch.ones_like(valid_s)
    is_new[:, 1:] = keys[:, 1:] != keys[:, :-1]
    is_new &= valid_s
    rank = torch.cumsum(is_new, dim=1, dtype=torch.int32) - 1
    num_voxels = is_new.sum(dim=1, dtype=torch.int32)
    in_cap = valid_s & (rank < max_voxels)
    # each voxel's key to its slot; everything else to a trash column cut off
    write = torch.where(is_new & in_cap, rank, max_voxels).long()
    out_keys = torch.full((b, max_voxels + 1), INT32_SENTINEL, dtype=torch.int32, device=dev)
    out_keys.scatter_(1, write, keys)
    out_keys = out_keys[:, :max_voxels]
    ids = torch.empty((b, p), dtype=torch.int32, device=dev)
    ids.scatter_(1, order, torch.where(in_cap, rank, -1))
    return (delinearize(out_keys, (gz, gy, gx)), out_keys != INT32_SENTINEL, ids,
            num_voxels)

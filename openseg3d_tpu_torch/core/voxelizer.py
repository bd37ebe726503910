"""Dynamic voxelization and the majority voxel labeler (host side).

A copy of ``openseg3d_tpu/core/voxelizer.py:23-157``: that module's package
imports JAX (``openseg3d_tpu/core/__init__.py`` pulls in ``core/metrics.py``),
and the GPU machine has no JAX. As there, ``VoxelGenerator.generate`` runs the
C++ voxelizer (``native/``, a copy of the JAX package's) whenever it builds,
and the numpy path here otherwise; ``native.available()`` says which.
``tests/test_torch_host.py`` and ``tests/test_torch_native.py`` hold both
paths equal to the JAX package's.

Every in-range point gets a voxel id, coords come back in zyx order, and voxel
ids are in ascending linearized-key order (the sparse conv and window
partition rely on key-sorted slots). Out-of-range points get id -1.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..utils.profiling import span


class VoxelGenerator:
    """Same constructor contract as the JAX package's VoxelGenerator."""

    def __init__(self, voxel_size, point_cloud_range):
        point_cloud_range = np.array(point_cloud_range, dtype=np.float32)
        voxel_size = np.array(voxel_size, dtype=np.float32)
        g = (point_cloud_range[3:] - point_cloud_range[:3]) / voxel_size
        self._grid_size = np.round(g).astype(np.int64)
        self._voxel_size = voxel_size
        self._point_cloud_range = point_cloud_range

    @property
    def voxel_size(self):
        return self._voxel_size

    @property
    def point_cloud_range(self):
        return self._point_cloud_range

    @property
    def grid_size(self):
        return self._grid_size

    def generate(self, points: np.ndarray):
        """points [N, >=3] (x,y,z,...) -> (voxel_coords [M,3] int32 zyx,
        point_voxel_ids [N] int32, -1 = out of range), through the C++
        voxelizer when it builds (the production path), else numpy."""
        with span('voxelize'):
            if native.available():
                return native.native_points_to_voxel(points, self._voxel_size,
                                                     self._point_cloud_range)
            return points_to_voxel(points, self._voxel_size, self._point_cloud_range)


def points_to_voxel(points: np.ndarray, voxel_size, coors_range):
    """Vectorized dynamic voxelization: per-axis floor binning, strict
    [0, grid) bounds, zyx coords, voxel ids in ascending key order."""
    voxel_size = np.asarray(voxel_size, dtype=points.dtype)
    coors_range = np.asarray(coors_range, dtype=points.dtype)
    gs = np.round((coors_range[3:] - coors_range[:3]) / voxel_size).astype(np.int64)

    xyz = points[:, :3]
    c = np.floor((xyz - coors_range[:3]) / voxel_size).astype(np.int64)
    valid = np.all((c >= 0) & (c < gs), axis=1)

    # linear key over (z, y, x), z-major
    key = (c[:, 2] * gs[1] + c[:, 1]) * gs[0] + c[:, 0]
    uniq, inverse = np.unique(key[valid], return_inverse=True)

    point_voxel_ids = -np.ones(points.shape[0], dtype=np.int32)
    point_voxel_ids[valid] = inverse.astype(np.int32)

    z = uniq // (gs[1] * gs[0])
    rem = uniq % (gs[1] * gs[0])
    y = rem // gs[0]
    x = rem % gs[0]
    coors = np.stack([z, y, x], axis=1).astype(np.int32)
    return coors, point_voxel_ids


def majority_voxel_labels(point_voxel_ids: np.ndarray, point_labels: np.ndarray,
                          num_voxels: int, ignore_index: int = 255) -> np.ndarray:
    """Per-voxel majority label vote: all point labels take part (including
    ignore_index), ties go to the smallest label, voxels with no points keep
    ignore_index."""
    vids = np.asarray(point_voxel_ids)
    labels = np.asarray(point_labels).astype(np.int64)
    m = vids >= 0
    vids = vids[m].astype(np.int64)
    labels = labels[m]

    out = np.full(num_voxels, ignore_index, dtype=np.int32)
    if vids.size == 0:
        return out

    # sort by (voxel, label); count run lengths; per voxel pick the label of the
    # longest run (ties -> smallest label because of the secondary sort key).
    order = np.lexsort((labels, vids))
    sv, sl = vids[order], labels[order]
    pair = sv * 256 + sl
    run_start = np.empty(pair.size, dtype=bool)
    run_start[0] = True
    run_start[1:] = pair[1:] != pair[:-1]
    starts = np.flatnonzero(run_start)
    counts = np.diff(np.append(starts, pair.size))
    run_voxel = sv[starts]
    run_label = sl[starts]

    # stable argmax per voxel: order runs by (voxel, -count, label)
    run_order = np.lexsort((run_label, -counts, run_voxel))
    rv = run_voxel[run_order]
    first_of_voxel = np.empty(rv.size, dtype=bool)
    first_of_voxel[0] = True
    first_of_voxel[1:] = rv[1:] != rv[:-1]
    win_voxel = rv[first_of_voxel]
    win_label = run_label[run_order][first_of_voxel]
    out[win_voxel] = win_label.astype(np.int32)
    return out

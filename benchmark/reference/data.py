"""The reference's input side: voxelization, the majority voxel labels and
the padded batch, in numpy.

Frozen copies of the port's host functions (``core/voxelizer``,
``native/voxelizer.cpp``, ``data/batch``) with one choice made plain: a
point's voxel is ``floor((p - range_min) * (1 / voxel_size))`` in float32,
the arithmetic of the C++ voxelizer that the program's production path runs
(the numpy path divides instead, and moves about one boundary point in
163840 into the next voxel). Voxel ids are in ascending key order.
"""

from __future__ import annotations

import numpy as np

IGNORE = 255


def grid_size(point_cloud_range, voxel_size) -> np.ndarray:
    """(gx, gy, gz) as the config computes it."""
    rng = np.asarray(point_cloud_range, dtype=np.float32)
    vs = np.asarray(voxel_size, dtype=np.float32)
    return np.round((rng[3:] - rng[:3]) / vs).astype(np.int64)


def voxelize(points: np.ndarray, voxel_size, point_cloud_range):
    """points [N, >=3] -> (coords [M, 3] int32 zyx, point_voxel_ids [N]
    int32, -1 out of range)."""
    vs = np.asarray(voxel_size, dtype=np.float32)
    lo = np.asarray(point_cloud_range, dtype=np.float32)[:3]
    gs = grid_size(point_cloud_range, voxel_size)
    inv = np.float32(1.0) / vs
    c = np.floor((points[:, :3].astype(np.float32) - lo) * inv).astype(np.int64)
    valid = np.all((c >= 0) & (c < gs), axis=1)
    key = (c[:, 2] * gs[1] + c[:, 1]) * gs[0] + c[:, 0]
    uniq, inverse = np.unique(key[valid], return_inverse=True)
    ids = -np.ones(points.shape[0], dtype=np.int32)
    ids[valid] = inverse.astype(np.int32)
    z = uniq // (gs[1] * gs[0])
    rem = uniq % (gs[1] * gs[0])
    coords = np.stack([z, rem // gs[0], rem % gs[0]], axis=1).astype(np.int32)
    return coords, ids


def majority_labels(ids: np.ndarray, labels: np.ndarray, num_voxels: int) -> np.ndarray:
    """Per-voxel majority of its points' labels, ties to the smallest label;
    voxels without points keep IGNORE."""
    m = ids >= 0
    out = np.full(num_voxels, IGNORE, dtype=np.int32)
    if not m.any():
        return out
    lab = labels[m].astype(np.int64)
    width = int(lab.max()) + 1
    counts = np.bincount(ids[m].astype(np.int64) * width + lab,
                         minlength=num_voxels * width).reshape(num_voxels, width)
    has = counts.sum(1) > 0
    out[has] = counts[has].argmax(1)
    return out


def padded_sample(points: np.ndarray, labels: np.ndarray | None, cfg: dict) -> dict:
    """One frame voxelized and padded to the config's capacities."""
    ds, rt = cfg['DATASET'], cfg['RUNTIME']
    cap_p, cap_v = int(rt['MAX_POINTS_PER_SAMPLE']), int(rt['MAX_VOXELS_PER_SAMPLE'])
    coords, ids = voxelize(points, ds['VOXEL_SIZE'], ds['POINT_CLOUD_RANGE'])
    n, m = min(points.shape[0], cap_p), min(coords.shape[0], cap_v)
    ids = np.where(ids[:n] >= cap_v, -1, ids[:n])
    out = {'points': np.zeros((cap_p, points.shape[1]), np.float32),
           'point_mask': np.arange(cap_p) < n,
           'point_voxel_ids': np.full(cap_p, -1, np.int32),
           'voxel_coords': np.full((cap_v, 3), -1, np.int32),
           'voxel_mask': np.arange(cap_v) < m}
    out['points'][:n] = points[:n]
    out['point_voxel_ids'][:n] = ids
    out['voxel_coords'][:m] = coords[:m]
    out['cur_point_mask'] = out['point_mask'].copy()
    if labels is not None:
        out['point_labels'] = np.full(cap_p, IGNORE, np.int32)
        out['point_labels'][:n] = labels[:n]
        out['voxel_labels'] = np.full(cap_v, IGNORE, np.int32)
        out['voxel_labels'][:m] = majority_labels(ids, labels[:n], coords.shape[0])[:m]
    return out


def batch(frames: list, cfg: dict, with_labels: bool) -> dict:
    """Frames ({'points', 'labels'}) -> the padded batch, numpy [B, cap, ...]."""
    samples = [padded_sample(f['points'], f['labels'] if with_labels else None, cfg)
               for f in frames]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

"""Fixed-capacity padded batches (numpy), and their move onto a device.

A copy of ``openseg3d_tpu/data/batch.py:25-117``: that module cannot be
imported without JAX (``openseg3d_tpu/data/__init__.py`` pulls in the dataset
and loader modules), and the GPU machine has no JAX. ``tests/test_torch_host.py``
holds the two equal array for array.

Padding conventions (used everywhere downstream):
  * padded point rows:  mask False, label = ignore_index, voxel id = -1
  * padded voxel rows:  mask False, coords = -1, label = ignore_index
  * point_voxel_ids are sample-local voxel slots.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.profiling import span

PAD_LABEL = 255


def pad_sample(sample: dict, max_points: int, max_voxels: int,
               ignore_index: int = PAD_LABEL, logger=None) -> dict:
    """Pad one dataset sample to fixed capacity. Overflow is truncated (and
    logged), as in the JAX package."""
    with span('pad'):
        return _pad_sample(sample, max_points, max_voxels, ignore_index, logger)


def _pad_sample(sample, max_points, max_voxels, ignore_index, logger):
    # the JAX package's pad_sample body, line for line
    pts = np.asarray(sample['points'], dtype=np.float32)
    n = pts.shape[0]
    if n > max_points:
        if logger is not None:
            logger.warning('truncating %d points to capacity %d', n, max_points)
        pts = pts[:max_points]
        n = max_points
    d = pts.shape[1]

    vids = np.asarray(sample['point_voxel_ids'], dtype=np.int32)[:n]
    coords = np.asarray(sample['voxel_coords'], dtype=np.int32)
    m = coords.shape[0]
    if m > max_voxels:
        if logger is not None:
            logger.warning('truncating %d voxels to capacity %d', m, max_voxels)
        coords = coords[:max_voxels]
        # points referencing dropped voxels become unassigned
        vids = np.where(vids >= max_voxels, -1, vids)
        m = max_voxels

    out: dict[str, Any] = {}
    points = np.zeros((max_points, d), dtype=np.float32)
    points[:n] = pts
    out['points'] = points

    point_mask = np.zeros(max_points, dtype=bool)
    point_mask[:n] = True
    out['point_mask'] = point_mask

    pvi = -np.ones(max_points, dtype=np.int32)
    pvi[:n] = vids
    out['point_voxel_ids'] = pvi

    vc = -np.ones((max_voxels, 3), dtype=np.int32)
    vc[:m] = coords
    out['voxel_coords'] = vc
    voxel_mask = np.zeros(max_voxels, dtype=bool)
    voxel_mask[:m] = True
    out['voxel_mask'] = voxel_mask

    # current-frame rows: labels / image features / range-image indices are
    # aligned with the current-frame point order, so they scatter onto cur rows
    if 'cur_point_indices' in sample:
        cur_all = np.asarray(sample['cur_point_indices'])
        keep = cur_all < max_points              # truncation-safe selection
        rows = cur_all[keep]
        cpm = np.zeros(max_points, dtype=bool)
        cpm[rows] = True
        out['cur_point_mask'] = cpm
    else:
        out['cur_point_mask'] = point_mask.copy()
        rows = np.arange(n)
        keep = slice(0, n)

    if 'point_labels' in sample:
        pl = np.full(max_points, ignore_index, dtype=np.int32)
        pl[rows] = np.asarray(sample['point_labels'], dtype=np.int32)[keep]
        out['point_labels'] = pl
    if 'voxel_labels' in sample:
        vl = np.full(max_voxels, ignore_index, dtype=np.int32)
        vl[:m] = np.asarray(sample['voxel_labels'], dtype=np.int32)[:m]
        out['voxel_labels'] = vl
    if 'point_image_features' in sample:
        f = np.asarray(sample['point_image_features'], dtype=np.float32)
        pif = np.zeros((max_points, f.shape[1]), dtype=np.float32)
        pif[rows] = f[keep]
        out['point_image_features'] = pif
    if 'points_ri' in sample:
        ri = -np.ones((max_points, 3), dtype=np.int32)
        ri[rows] = np.asarray(sample['points_ri'], dtype=np.int32)[keep]
        out['points_ri'] = ri

    out['num_points'] = np.int32(n)
    out['num_voxels'] = np.int32(m)
    return out


def collate_padded(samples: list[dict]) -> dict:
    """Stack padded samples into [B, cap, ...] arrays."""
    keys = samples[0].keys()
    with span('pad'):
        batch = {k: np.stack([s[k] for s in samples], axis=0) for k in keys}
    batch['batch_size'] = len(samples)
    return batch


def to_device(batch: dict, device) -> dict:
    """numpy batch -> dict of tensors on `device` (dtypes kept: bool masks,
    int32 ids and coords, float32 points). Non-array entries such as
    ``batch_size`` are dropped; the tensors' shapes carry it."""
    with span('h2d'):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

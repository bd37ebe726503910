"""Global point-cloud augmentations (host side, numpy).

A copy of ``openseg3d_tpu/data/transforms.py`` (that package's ``__init__``
imports JAX). The global ``np.random`` draws come in the same order, so under
one ``np.random`` seed both give the same cloud; ``tests/test_torch_data.py``
holds them equal.

All transforms operate on a data_dict with keys:
  points [N, D] (xyz + features), point_labels [Nc] (current points only),
  cur_point_indices [Nc] (optional; rows of `points` belonging to the current
  frame), point_image_features [Nc, Fi] (optional).
"""

from __future__ import annotations

import numpy as np


def rotate_z(points: np.ndarray, angle: float) -> np.ndarray:
    """Rotate xyz (first 3 columns) about z; angle increases x -> y
    (transform_utils.rotate_points_along_z)."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=points.dtype)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot
    return out


def _remap_current(data_dict: dict, choice: np.ndarray) -> None:
    """After reordering/subsampling `points` by `choice`, remap
    cur_point_indices and the current-frame-aligned arrays (labels, image
    features). Vectorized version of get_shuffled_indices."""
    cur = data_dict.get('cur_point_indices')
    if cur is None:
        for k in ('point_labels', 'point_image_features'):
            if data_dict.get(k) is not None:
                data_dict[k] = data_dict[k][choice]
        return
    # rank of each original row within the current-frame list (-1 = history)
    size = max(int(choice.max(initial=-1)), int(cur.max(initial=-1))) + 1
    pos_in_cur = np.full(size, -1, np.int64)
    pos_in_cur[cur] = np.arange(cur.shape[0])
    mapped = pos_in_cur[choice]                  # [N'] rank or -1
    keep = mapped >= 0
    data_dict['cur_point_indices'] = np.flatnonzero(keep)
    order = mapped[keep]
    for k in ('point_labels', 'point_image_features'):
        if data_dict.get(k) is not None:
            data_dict[k] = data_dict[k][order]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict


class RandomGlobalScaling:
    def __init__(self, scale_range):
        self.scale_range = scale_range

    def __call__(self, d):
        lo, hi = self.scale_range
        if hi - lo >= 1e-3:
            d['points'][:, :3] *= np.random.uniform(lo, hi)
        return d


class RandomGlobalRotation:
    def __init__(self, rot_range):
        self.rot_range = rot_range

    def __call__(self, d):
        angle = np.random.uniform(self.rot_range[0], self.rot_range[1])
        d['points'] = rotate_z(d['points'], angle)
        return d


class RandomGlobalTranslation:
    """Independent gaussian offset per axis (transform_utils
    random_translation_along_{x,y,z})."""

    def __init__(self, translate_std):
        self.std = translate_std

    def __call__(self, d):
        d['points'][:, :3] += np.random.normal(0, self.std, (1, 3))
        return d


class RandomFlip:
    """Independent 50% flips of y (about x-axis) then x (about y-axis)."""

    def __call__(self, d):
        if np.random.rand() < 0.5:
            d['points'][:, 1] = -d['points'][:, 1]
        if np.random.rand() < 0.5:
            d['points'][:, 0] = -d['points'][:, 0]
        return d


class PointShuffle:
    def __call__(self, d):
        choice = np.random.permutation(d['points'].shape[0])
        d['points'] = d['points'][choice]
        _remap_current(d, choice)
        return d


class PointSample:
    """Keep sample_ratio of points; far points (beyond sample_range) are kept
    preferentially (transform_utils.points_random_sampling:97-138)."""

    def __init__(self, sample_ratio, sample_range=None):
        self.sample_ratio = sample_ratio
        self.sample_range = sample_range

    def __call__(self, d):
        pts = d['points']
        n = pts.shape[0]
        num = min(int(n * self.sample_ratio), n)
        if self.sample_range is not None:
            dist = np.linalg.norm(pts[:, :2], axis=1)
            far = np.flatnonzero(dist >= self.sample_range)
            near = np.flatnonzero(dist < self.sample_range)
            if len(far) > num:
                far = np.random.choice(far, num, replace=False)
            near_num = max(num - len(far), 0)
            choice = np.concatenate(
                [far, np.random.choice(near, min(near_num, len(near)), replace=False)])
            np.random.shuffle(choice)
        else:
            choice = np.random.choice(n, num, replace=False)
        d['points'] = pts[choice]
        _remap_current(d, choice)
        return d


class RandomDropPointsColor:
    """Zero all image features with probability drop_ratio
    (transforms.py:33-77)."""

    def __init__(self, drop_ratio=0.2):
        self.drop_ratio = drop_ratio

    def __call__(self, d):
        f = d.get('point_image_features')
        if f is not None and np.random.rand() > 1.0 - self.drop_ratio:
            d['point_image_features'] = f * 0.0
        return d

"""Test-time augmentation (host side).

A copy of ``openseg3d_tpu/data/test_time_aug.py``: the cartesian product of
scales x angles x flip_x x flip_y, each variant transformed from the raw
cartesian frame, re-voxelized and re-padded; the caller averages the softmax
over the variants (``tools/eval.py``). With num_workers > 0 a spawned pool
prepares the variants by frame index (each worker owns a dataset replica and
loads the raw frame itself) ahead of the device. ``tests/test_torch_data.py``
holds the variants equal to the original's.
"""

from __future__ import annotations

import multiprocessing as mp

import numpy as np

from .batch import collate_padded
from .transforms import rotate_z

_tta_worker = None


def _tta_init(dataset_factory):
    global _tta_worker
    _tta_worker = dataset_factory()


def _tta_prepare(task):
    index, scale, angle, fx, fy = task
    raw = _tta_worker.load_raw(index)
    return _prepare_variant(_tta_worker, raw, scale, angle, fx, fy)


def _prepare_variant(dataset, data, scale, angle, fx, fy):
    d = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in data.items()
         if k in ('points', 'point_image_features', 'point_labels',
                  'cur_point_indices', 'points_ri')}
    pts = d['points']
    pts[:, :3] *= scale
    pts = rotate_z(pts, angle)
    if fx:
        pts[:, 1] = -pts[:, 1]
    if fy:
        pts[:, 0] = -pts[:, 0]
    d['points'] = pts
    d = dataset.prepare_data(d)
    if 'point_labels' in d:
        dataset.prepare_voxel_labels(d)
    return collate_padded([dataset.pad(d)])


class MultiScaleFlipAug:
    def __init__(self, dataset, scales=(0.95, 1.0, 1.05),
                 angles=(-np.pi / 4, 0.0, np.pi / 4),
                 flip_x=True, flip_y=True,
                 dataset_factory=None, num_workers: int = 0):
        self.dataset = dataset
        self.scales = list(scales)
        self.angles = list(angles)
        self.flip_x = [True, False] if flip_x else [False]
        self.flip_y = [True, False] if flip_y else [False]
        self._pool = None
        if num_workers > 0:
            if dataset_factory is None:
                raise ValueError('num_workers > 0 requires a picklable '
                                 'dataset_factory')
            # spawn, not fork: the same reason as in data/loader.py
            ctx = mp.get_context('spawn')
            self._pool = ctx.Pool(num_workers, initializer=_tta_init,
                                  initargs=(dataset_factory,))

    def num_variants(self):
        return len(self.scales) * len(self.angles) * len(self.flip_x) * len(self.flip_y)

    def _variant_params(self):
        for scale in self.scales:
            for angle in self.angles:
                for fx in self.flip_x:
                    for fy in self.flip_y:
                        yield scale, angle, fx, fy

    def __call__(self, data, index=None):
        """data: raw sample dict with at least 'points' (+ optional labels /
        image features). Yields padded single-sample batches per variant.

        With a worker pool, pass the frame `index` instead of shipping the raw
        cloud: workers re-load it and prepare variants ahead of the consumer
        (imap preserves variant order)."""
        if self._pool is not None and index is not None:
            tasks = [(index,) + p for p in self._variant_params()]
            yield from self._pool.imap(_tta_prepare, tasks)
            return
        for scale, angle, fx, fy in self._variant_params():
            yield _prepare_variant(self.dataset, data, scale, angle, fx, fy)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

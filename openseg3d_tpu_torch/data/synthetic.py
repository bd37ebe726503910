"""Synthetic LiDAR dataset with the WaymoDataset surface.

A copy of ``openseg3d_tpu/data/synthetic.py``, on the port's numpy
voxelizer. Used by ``tools.train --synthetic`` (training without the Waymo
files) and by ``tools.eval --synthetic``. Frame i is drawn from
``RandomState(seed + i)``: radial ground sweep plus vertical structure
clusters, labels a fixed function of the geometry so that a model can learn
them. ``tests/test_torch_data.py`` holds it equal to the original.
"""

from __future__ import annotations

import numpy as np

from ..core.voxelizer import VoxelGenerator, majority_voxel_labels
from ..utils.pointops import cart2polar
from .batch import pad_sample


class SyntheticDataset:
    def __init__(self, cfg, num_frames: int = 64, n_points: int | None = None,
                 mode: str = 'training', seed: int = 0, logger=None):
        self.cfg = cfg
        self.mode = mode
        self.num_frames = num_frames
        self.n_points = n_points or min(cfg.RUNTIME.MAX_POINTS_PER_SAMPLE, 163840)
        self.seed = seed
        self.logger = logger
        self.voxel_generator = VoxelGenerator(cfg.DATASET.VOXEL_SIZE,
                                              cfg.DATASET.POINT_CLOUD_RANGE)
        self.grid_size = self.voxel_generator.grid_size
        self.voxel_size = self.voxel_generator.voxel_size
        self.point_cloud_range = self.voxel_generator.point_cloud_range

    # surface parity with WaymoDataset
    @property
    def dim_point(self):
        return self.cfg.DATASET.DIM_POINT

    @property
    def use_multi_sweeps(self):
        return self.cfg.DATASET.USE_MULTI_SWEEPS

    @property
    def use_cylinder(self):
        return self.cfg.DATASET.USE_CYLINDER

    @property
    def num_classes(self):
        return self.cfg.DATASET.NUM_CLASSES

    @property
    def class_names(self):
        return self.cfg.DATASET.CLASS_NAMES or [f'c{i}' for i in range(self.num_classes)]

    @property
    def ignore_index(self):
        return self.cfg.DATASET.IGNORE_INDEX

    def __len__(self):
        return self.num_frames

    def _frame(self, index):
        rng = np.random.RandomState(self.seed + index)
        n = self.n_points
        rg = np.asarray(self.cfg.DATASET.POINT_CLOUD_RANGE, np.float32)
        if self.use_cylinder:
            # cylinder configs express the range as (rho, phi, z); the
            # generator works in cartesian (prepare_data converts), so the
            # usable cartesian span is the rho disk
            span = np.asarray([rg[3], rg[3]], np.float32) / 2 * 0.95
        else:
            span = (rg[3:5] - rg[0:2]) / 2 * 0.95
        zlo, zhi = rg[2] * 0.95, rg[5] * 0.95
        n_ground = int(n * 0.55)
        r = np.sqrt(rng.uniform(1.0, (min(span) * 0.98) ** 2, n_ground))
        az = rng.uniform(-np.pi, np.pi, n_ground)
        ground = np.stack([r * np.cos(az), r * np.sin(az),
                           np.full(n_ground, zlo + 0.05)], 1)
        n_struct = n - n_ground
        k = max(8, n // 2048)
        centers = rng.uniform(-span * 0.9, span * 0.9, (k, 2))
        ci = rng.randint(0, k, n_struct)
        struct = np.stack([
            centers[ci, 0] + rng.normal(0, 1.5, n_struct),
            centers[ci, 1] + rng.normal(0, 1.5, n_struct),
            rng.uniform(zlo, zhi, n_struct)], 1)
        xyz = np.concatenate([ground, struct]).astype(np.float32)
        feats = rng.randn(n, self.dim_point - 3).astype(np.float32)
        points = np.concatenate([xyz, feats], 1)
        # learnable labels: ground is 'Road' (17); each structure cluster's
        # class is a FIXED geometric code of its center — azimuth sector (7)
        # x radial band (3) -> the 21 non-ground classes. The same map holds
        # in every frame, so position->class is consistent and a model can
        # generalize to held-out frames (cluster-id % k, used before, was
        # random w.r.t. geometry across frames and capped mIoU near chance).
        labels = np.empty(n, np.int64)
        labels[:n_ground] = 17
        az_c = np.arctan2(centers[:, 1], centers[:, 0])
        r_c = np.hypot(centers[:, 0], centers[:, 1])
        sector = np.minimum((az_c + np.pi) / (2 * np.pi) * 7, 6.0).astype(np.int64)
        r_max = float(np.hypot(span[0], span[1])) * 0.9
        band = np.minimum(r_c / r_max * 3, 2.0).astype(np.int64)
        struct_classes = np.asarray(
            [c for c in range(self.num_classes) if c != 17], np.int64)
        labels[n_ground:] = struct_classes[(band * 7 + sector)[ci]]
        # intensity carries a class cue too (real LiDAR intensity correlates
        # with material). Unlike the positional code this survives TTA's
        # rotations/flips untouched, so TTA softmax-averaging stays sound.
        points[:, 3] = (labels / self.num_classes - 0.5) * 2.0 \
            + 0.4 * points[:, 3]
        return points, labels

    def prepare_data(self, d):
        if self.cfg.DATASET.USE_CYLINDER:
            pts = d['points']
            d['points'] = np.concatenate([cart2polar(pts), pts[:, :2], pts[:, 3:]],
                                         axis=1).astype(np.float32)
        coords, ids = self.voxel_generator.generate(d['points'])
        d['voxel_coords'] = coords
        d['point_voxel_ids'] = ids
        return d

    def prepare_voxel_labels(self, d):
        d['voxel_labels'] = majority_voxel_labels(
            d['point_voxel_ids'], d['point_labels'],
            d['voxel_coords'].shape[0], self.ignore_index)

    def load_raw(self, index):
        """Raw cartesian sample, pre-prepare_data (see WaymoDataset.load_raw)."""
        points, labels = self._frame(index)
        return {'filename': f'synthetic-{index:06d}-{index}',
                'points': points, 'point_labels': labels}

    def __getitem__(self, index):
        d = self.load_raw(index)
        d = self.prepare_data(d)
        self.prepare_voxel_labels(d)
        return d

    def pad(self, d):
        return pad_sample(d, self.cfg.RUNTIME.MAX_POINTS_PER_SAMPLE,
                          self.cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE,
                          self.ignore_index, logger=self.logger)

    def load_padded(self, index):
        d = self[index]
        return self.pad(d), d['filename']

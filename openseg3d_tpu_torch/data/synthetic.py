"""Synthetic LiDAR dataset with the WaymoDataset surface.

A copy of ``openseg3d_tpu/data/synthetic.py``, on the port's numpy
voxelizer. Used by ``tools.train --synthetic`` (training without the Waymo
files) and by ``tools.eval --synthetic``. Frame i is drawn from
``RandomState(seed + i)``: radial ground sweep plus vertical structure
clusters, labels a fixed function of the geometry so that a model can learn
them. ``tests/test_torch_data.py`` holds it equal to the original.

``make_waymo_like_cloud`` is a copy of ``bench.make_waymo_like_cloud``, the
frame of the JAX package's benchmark, which ``chip_smoke.py`` runs through
the port.
"""

from __future__ import annotations

import numpy as np

from ..core.voxelizer import VoxelGenerator, majority_voxel_labels
from ..utils.pointops import cart2polar
from .batch import pad_sample


def make_waymo_like_cloud(rng, n_points: int):
    """Synthetic LiDAR frame with a real beam model: 64 elevation beams swept
    over azimuth columns; each ray hits either the ground plane (range set by
    beam geometry — dense near-field, sparse far-field like a real spinning
    lidar) or a random vertical obstacle. This reproduces Waymo's voxel
    occupancy statistics (~60-90k occupied 0.1m voxels per ~160k-point frame)
    far better than uniform sampling, which matters because sparse-conv cost
    scales with occupancy structure."""
    sensor_h = 2.0
    n_beams = 64
    n_cols = max(n_points // n_beams, 1)
    elev = np.linspace(np.deg2rad(-18.0), np.deg2rad(2.5), n_beams)
    az = np.linspace(-np.pi, np.pi, n_cols, endpoint=False)
    az = az[None, :] + rng.normal(0, 1e-3, (n_beams, n_cols))
    el = np.broadcast_to(elev[:, None], (n_beams, n_cols)).copy()

    # ground-return range per ray; upward beams get "sky" (clipped far)
    with np.errstate(divide='ignore'):
        r_ground = np.where(el < -1e-3, sensor_h / np.tan(-el), 75.0)
    # obstacles: ~200 buildings/cars at random azimuth spans
    r = np.minimum(r_ground, 74.0)
    n_obs = 200
    ob_az = rng.uniform(-np.pi, np.pi, n_obs)
    ob_w = rng.uniform(0.02, 0.15, n_obs)        # azimuth half-width
    ob_r = rng.uniform(4.0, 70.0, n_obs)
    ob_h = rng.uniform(0.5, 5.0, n_obs)
    for i in range(n_obs):
        hit = (np.abs((az - ob_az[i] + np.pi) % (2 * np.pi) - np.pi) < ob_w[i])
        # the obstacle truncates rays whose ground range exceeds its range and
        # whose height at the obstacle is below its top
        z_at = sensor_h + np.tan(el) * ob_r[i]
        hit &= (r > ob_r[i]) & (z_at < ob_h[i] - 1.9)
        r = np.where(hit, ob_r[i] * rng.uniform(0.98, 1.0), r)

    r = (r * rng.uniform(0.995, 1.005, r.shape)).clip(1.5, 75.0)
    x = r * np.cos(el) * np.cos(az)
    y = r * np.cos(el) * np.sin(az)
    z = sensor_h + r * np.sin(el) - 1.9          # sensor ~1.9m above ground
    xyz = np.stack([x, y, z], -1).reshape(-1, 3)
    xyz = xyz[:n_points]
    if xyz.shape[0] < n_points:
        xyz = np.concatenate([xyz, xyz[:n_points - xyz.shape[0]] + 0.05])
    feats = rng.randn(n_points, 3).astype(np.float32)
    return np.concatenate([xyz.astype(np.float32), feats], 1)


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

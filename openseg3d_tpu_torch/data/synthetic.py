"""Synthetic LiDAR dataset with the WaymoDataset surface.

A copy of ``openseg3d_tpu/data/synthetic.py``, on the port's numpy
voxelizer. Used by ``tools.train --synthetic`` (training without the Waymo
files) and by ``tools.eval --synthetic``. Frame i is drawn from
``RandomState(seed + i)``: radial ground sweep plus vertical structure
clusters, labels a fixed function of the geometry so that a model can learn
them. ``tests/test_torch_data.py`` holds it equal to the original.

``make_waymo_like_cloud`` is a copy of ``bench.make_waymo_like_cloud``, the
frame of the JAX package's benchmark, which ``chip_smoke.py`` runs through
the port; ``bench_frame`` voxelizes and pads one such frame.
``make_tree`` follows ``tools/rehearsal.make_tree``: frames of that
generator written in the offline parser's on-disk format, for the Waymo
reader, with the range-image index in the parser's column order (col, row,
return; the rehearsal tool writes (0, col, row), which the submission writer
reads as column 0, so that at most 128 of a frame's points reach the range
image). Both can add synthetic per-point image features
(``synthetic_image_features``) for the DeepFusion branch: real ones come
from a 2D network (``tools/extract_image_feature.py``) whose weights the
repository does not hold.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..core.voxelizer import VoxelGenerator, majority_voxel_labels
from ..utils.pointops import cart2polar
from .batch import collate_padded, pad_sample


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


CAMERA_HALF_ANGLE = 2 * np.pi / 3


def synthetic_image_features(rng, xyz: np.ndarray, dim: int) -> np.ndarray:
    """[N, dim] float32 stand-ins for per-point 2D class scores: standard
    normal from `rng` for the points a forward-looking camera rig sees
    (azimuth |atan2(y, x)| <= 120 degrees, two thirds of a spinning lidar's
    sweep) and all-zero rows, the reader's "no projection", behind."""
    f = rng.standard_normal((xyz.shape[0], dim)).astype(np.float32)
    f[np.abs(np.arctan2(xyz[:, 1], xyz[:, 0])) > CAMERA_HALF_ANGLE] = 0
    return f


def bench_cloud(cfg, n_points: int | None = None, seed: int = 0, cloud=None,
                image_features: bool = False) -> dict:
    """The raw benchmark frame: ``make_waymo_like_cloud`` of n_points from
    RandomState(seed), or `cloud` ([N, 6] xyz + features), as `points`,
    with random `point_labels` drawn next from the same generator, and with
    `image_features` DIM_IMAGE_FEATURE synthetic ones drawn after them
    (``synthetic_image_features``) as `point_image_features`."""
    rng = np.random.RandomState(seed)
    pts = make_waymo_like_cloud(rng, n_points) if cloud is None else cloud
    raw = dict(points=pts, point_labels=rng.randint(0, cfg.DATASET.NUM_CLASSES, pts.shape[0]))
    if image_features:
        raw['point_image_features'] = synthetic_image_features(
            rng, pts[:, :3], cfg.DATASET.DIM_IMAGE_FEATURE)
    return raw


def bench_frame(cfg, n_points: int | None = None, seed: int = 0, cloud=None,
                image_features: bool = False) -> dict:
    """The padded numpy batch (B = 1) of one benchmark frame under `cfg`:
    ``bench_cloud``'s points, as (rho, phi, z, x, y, features) where
    DATASET.USE_CYLINDER is set, voxelized, with its labels (and image
    features), padded to the RUNTIME capacities."""
    sample = bench_cloud(cfg, n_points, seed, cloud, image_features)
    pts = sample['points']
    if cfg.DATASET.USE_CYLINDER:
        pts = np.concatenate([cart2polar(pts), pts[:, :2], pts[:, 3:]], 1).astype(np.float32)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    coords, ids = vg.generate(pts)
    sample.update(points=pts, voxel_coords=coords, point_voxel_ids=ids,
                  voxel_labels=majority_voxel_labels(ids, sample['point_labels'],
                                                     coords.shape[0]))
    return collate_padded([pad_sample(sample, cfg.RUNTIME.MAX_POINTS_PER_SAMPLE,
                                      cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE)])


def make_tree(root: str, n_frames: int, n_points: int,
              image_feature_dim: int | None = None) -> list:
    """Write n_frames frames of one segment (frame f: pose translated f x
    0.5 m in x, timestamp 1000000 + f) in the layout of
    ``tools/waymo_parser.py``: 15-column lidar .npy (range-image index in
    the last 3), [N, 2] labels a function of height and range, 4x4 pose
    .txt, an instance bank, and the test-set frame list naming every
    frame. With image_feature_dim, also image_feature/<frame>.npy as
    ``tools/extract_image_feature.py`` saves it, a pickled {point index:
    vector} of the points a camera sees, with ``synthetic_image_features``
    from RandomState(1 + f) (the lidar files stay as without them).
    Returns the frame names."""
    rng = np.random.RandomState(0)
    subs = ('lidar', 'label', 'pose', 'instances') + (('image_feature',) if image_feature_dim
                                                      else ())
    for sub in subs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = []
    for f in range(n_frames):
        name = f'seg{f // 4:03d}-{1000000 + f}-{f % 4}'
        names.append(name)
        cloud = make_waymo_like_cloud(rng, n_points)      # [N, 6] xyz + feats
        pts = np.zeros((n_points, 15), np.float32)
        pts[:, :3] = cloud[:, :3]
        pts[:, 3] = np.linalg.norm(cloud[:, :3], axis=1)  # range
        pts[:, 4] = np.abs(cloud[:, 3])                   # intensity
        pts[:, 5] = np.abs(cloud[:, 4])                   # elongation
        # range-image index (col, row, return) as the parser writes it: a
        # pixel of its own for each of the first 64 x 2650 points
        pts[:, 12] = np.arange(n_points) % 2650
        pts[:, 13] = np.arange(n_points) // 2650 % 64
        pts[:, 14] = 0
        np.save(os.path.join(root, 'lidar', name + '.npy'), pts)
        lbl = np.zeros((n_points, 2), np.int64)
        z, r = cloud[:, 2], pts[:, 3]
        lbl[:, 1] = (1 + (z > -1.0).astype(np.int64) * 10
                     + np.clip(r / 8, 0, 10).astype(np.int64))
        np.save(os.path.join(root, 'label', name + '.npy'), lbl)
        pose = np.eye(4)
        pose[0, 3] = f * 0.5
        np.savetxt(os.path.join(root, 'pose', name + '.txt'), pose)
        if image_feature_dim:
            feats = synthetic_image_features(np.random.RandomState(1 + f), cloud[:, :3],
                                             image_feature_dim)
            seen = np.flatnonzero(np.abs(feats).sum(1) > 0)
            np.save(os.path.join(root, 'image_feature', name + '.npy'),
                    {int(i): feats[i] for i in seen}, allow_pickle=True)
    bank = {3: [], 4: [], 10: []}
    for lid in bank:
        for _ in range(3):
            cp = np.zeros((60, 6), np.float32)
            cp[:, :3] = rng.uniform(-0.6, 0.6, (60, 3)) + [5.0, 5.0, -1.6]
            bank[lid].append({'cluster_points': cp, 'cluster_height': 0.5})
    with open(os.path.join(root, 'instances', 'lidar_instances_with_height.pkl'), 'wb') as fh:
        pickle.dump(bank, fh)
    with open(os.path.join(root, '3d_semseg_test_set_frames.txt'), 'w') as fh:
        for name in names:
            fi, ts, _ = name.split('-')
            fh.write(f'{fi},{ts},x\n')
    return names


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

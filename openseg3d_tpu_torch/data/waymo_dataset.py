"""Waymo Open Dataset reader (per-frame .npy files).

A copy of ``openseg3d_tpu/data/waymo_dataset.py``, on the port's numpy
voxelizer: the on-disk layout that ``tools/waymo_parser.py`` writes (lidar/
label/ pose/ image_feature/ instances/ 3d_semseg_test_set_frames.txt), the
15-dim point schema, multi-sweep ego-motion alignment, 1-based -> 0-based
labels with 0 -> 255, cylinder coordinates, and single-sweep instance-paste +
PolarMix training augmentation. Voxelization happens here (host side),
padding to the RUNTIME capacities in ``load_padded``. The constructor draws
PolarMix's two angles from the global ``np.random``, as the original does;
``tests/test_torch_data.py`` holds the two equal under one seed.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..core.voxelizer import VoxelGenerator, majority_voxel_labels
from ..utils.pointops import cart2polar
from .batch import pad_sample
from .instance_augmentation import InstanceAugmentation
from .polarmix import PolarMix
from . import transforms as T


class WaymoDataset:
    def __init__(self, cfg, data_root, mode='training', logger=None):
        assert mode in ('training', 'validation', 'testing')
        self.cfg = cfg
        self.data_root = data_root
        self.mode = mode
        self.logger = logger

        all_filenames = self._dir_filenames('lidar')
        self.file_idx_to_name = {}
        for fn in all_filenames:
            file_idx, frame_idx, _ = self.parse_filename(fn)
            self.file_idx_to_name[(file_idx, frame_idx)] = fn

        if mode == 'testing':
            self.filenames = self._testing_filenames(all_filenames)
        else:
            self.filenames = self._dir_filenames('label')

        self.voxel_generator = VoxelGenerator(cfg.DATASET.VOXEL_SIZE,
                                              cfg.DATASET.POINT_CLOUD_RANGE)
        self.grid_size = self.voxel_generator.grid_size
        self.voxel_size = self.voxel_generator.voxel_size
        self.point_cloud_range = self.voxel_generator.point_cloud_range

        self.polar_mix = PolarMix(
            instance_classes=list(range(13)),
            rot_angle_range=[np.random.random() * np.pi * 2 / 3,
                             (np.random.random() + 1) * np.pi * 2 / 3])
        self.instance_aug = InstanceAugmentation(
            instance_path=os.path.join(data_root,
                                       'instances/lidar_instances_with_height.pkl'))
        self.transforms = T.Compose([
            T.RandomGlobalRotation(cfg.DATASET.AUG_ROT_RANGE),
            T.RandomGlobalScaling(cfg.DATASET.AUG_SCALE_RANGE),
            T.RandomGlobalTranslation(cfg.DATASET.AUG_TRANSLATE_STD),
            T.RandomFlip(),
            T.PointShuffle(),
            T.PointSample(cfg.DATASET.AUG_SAMPLE_RATIO, cfg.DATASET.AUG_SAMPLE_RANGE),
        ])

    # ----- properties mirroring the reference dataset surface -----
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
        return self.cfg.DATASET.CLASS_NAMES

    @property
    def use_image_feature(self):
        return self.cfg.DATASET.USE_IMAGE_FEATURE

    @property
    def dim_image_feature(self):
        return self.cfg.DATASET.DIM_IMAGE_FEATURE

    @property
    def ignore_index(self):
        return self.cfg.DATASET.IGNORE_INDEX

    # ----- filename plumbing -----
    @staticmethod
    def parse_filename(filename):
        file_idx, ts, frame_idx = filename.split('-')[:3]
        return file_idx, int(frame_idx), np.int64(ts)

    def _dir_filenames(self, d):
        return sorted(os.path.splitext(os.path.basename(p))[0]
                      for p in glob.glob(os.path.join(self.data_root, d, '*.npy')))

    def _testing_filenames(self, filenames):
        frames = set()
        with open(os.path.join(self.data_root, '3d_semseg_test_set_frames.txt')) as fp:
            for line in fp.read().splitlines():
                file_idx, ts = line.split(',')[:2]
                frames.add((file_idx, np.int64(ts)))
        return [fn for fn in filenames
                if (self.parse_filename(fn)[0], self.parse_filename(fn)[2]) in frames]

    # ----- loading -----
    def load_points(self, filename):
        pts = np.load(os.path.join(self.data_root, 'lidar', filename + '.npy'))
        pts = pts.astype(np.float32)
        pts[:, 3] = 0                      # range column reset (timestamp slot)
        pts[:, 4] = np.tanh(pts[:, 4])     # intensity normalization
        return pts

    def load_pose(self, filename):
        return np.loadtxt(os.path.join(self.data_root, 'pose', filename + '.txt'))

    def load_label(self, filename):
        lbl = np.load(os.path.join(self.data_root, 'label', filename + '.npy'))[:, 1]
        lbl = lbl.astype(np.int64) - 1
        lbl[lbl == -1] = self.ignore_index
        return lbl

    def load_image_features(self, num_points, filename):
        d = np.load(os.path.join(self.data_root, 'image_feature', filename + '.npy'),
                    allow_pickle=True).item()
        out = np.zeros((num_points, self.dim_image_feature), np.float32)
        for k, v in d.items():
            out[k] = v
        return out

    def load_points_from_sweeps(self, filename, num_sweeps=3, max_num_sweeps=5):
        """Current frame + up to num_sweeps-1 history sweeps warped into the
        current frame via pose inverse composition; column 3 = timestamp delta
        (waymo_dataset.py:156-202)."""
        file_idx, frame_idx, timestamp = self.parse_filename(filename)
        points = self.load_points(filename)
        cur_point_indices = np.arange(points.shape[0])
        ts = timestamp / 1e6
        pose = self.load_pose(filename)

        history = []
        for i in range(max_num_sweeps - 1):
            j = frame_idx - i - 1
            if j >= 0 and (file_idx, j) in self.file_idx_to_name:
                history.append(self.file_idx_to_name[(file_idx, j)])

        want = num_sweeps - 1
        if len(history) <= want:
            choices = np.arange(len(history))
        elif self.mode == 'training':
            choices = np.random.choice(len(history), want, replace=False)
        else:
            choices = np.arange(want)

        sweeps = [points]
        inv = np.linalg.inv(pose)
        for i in choices:
            fn = history[i]
            sp = self.load_points(fn)
            s_ts = self.parse_filename(fn)[2] / 1e6
            rel = inv @ self.load_pose(fn)
            sp[:, :3] = sp[:, :3] @ rel[:3, :3].T + rel[:3, 3]
            sp[:, 3] = ts - s_ts
            sweeps.append(sp)
        return np.concatenate(sweeps, axis=0), cur_point_indices

    # ----- per-frame pipeline -----
    def prepare_data(self, data_dict):
        """Augment (train) + cylinder transform + voxelize
        (waymo_dataset.py:248-279)."""
        if self.mode == 'training' and self.cfg.DATASET.AUG_DATA:
            data_dict = self.transforms(data_dict)

        if self.cfg.DATASET.USE_CYLINDER:
            pts = data_dict['points']
            polar = cart2polar(pts)
            data_dict['points'] = np.concatenate(
                [polar, pts[:, :2], pts[:, 3:]], axis=1).astype(np.float32)

        coords, ids = self.voxel_generator.generate(data_dict['points'])
        data_dict['voxel_coords'] = coords
        data_dict['point_voxel_ids'] = ids
        return data_dict

    def prepare_voxel_labels(self, data_dict):
        ids = data_dict['point_voxel_ids']
        cur = data_dict.get('cur_point_indices')
        cur_ids = ids[cur] if cur is not None else ids
        data_dict['voxel_labels'] = majority_voxel_labels(
            cur_ids, data_dict['point_labels'],
            data_dict['voxel_coords'].shape[0], self.ignore_index)

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index):
        d = self.load_raw(index)
        d = self.prepare_data(d)
        if self.mode != 'testing':
            self.prepare_voxel_labels(d)
        return d

    def load_raw(self, index):
        """Load a sample BEFORE prepare_data: cartesian points, labels, aug.
        TTA (MultiScaleFlipAug) must transform this raw form — prepare_data
        rewrites 'points' into cylinder layout and voxelizes, so transforming
        a prepared sample would rotate (rho, phi, z) columns."""
        filename = self.filenames[index]
        d = {'filename': filename}

        if self.use_multi_sweeps:
            pts, cur = self.load_points_from_sweeps(
                filename, self.cfg.DATASET.NUM_SWEEPS, self.cfg.DATASET.MAX_NUM_SWEEPS)
            d['cur_point_indices'] = cur
        else:
            pts = self.load_points(filename)
        d['points'] = pts[:, :self.dim_point]

        if self.use_image_feature:
            n = (d['cur_point_indices'].shape[0] if self.use_multi_sweeps
                 else d['points'].shape[0])
            d['point_image_features'] = self.load_image_features(n, filename)

        if self.mode != 'testing':
            d['point_labels'] = self.load_label(filename)

        # single-sweep training: instance paste + PolarMix with a second scan
        if (self.mode == 'training' and self.cfg.DATASET.AUG_DATA
                and not self.use_multi_sweeps):
            fn2 = self.filenames[np.random.randint(len(self.filenames))]
            pts2 = self.load_points(fn2)[:, :self.dim_point]
            lbl2 = self.load_label(fn2)
            if self.use_image_feature:
                f2 = self.load_image_features(pts2.shape[0], fn2)
                d['points'], d['point_image_features'], d['point_labels'] = \
                    self.instance_aug(d['points'], d['point_image_features'],
                                      d['point_labels'])
                d['points'], d['point_image_features'], d['point_labels'] = \
                    self.polar_mix(d['points'], d['point_image_features'],
                                   d['point_labels'], pts2, f2, lbl2)
            else:
                d['points'], d['point_labels'] = self.instance_aug(
                    d['points'], None, d['point_labels'])
                d['points'], d['point_labels'] = self.polar_mix(
                    d['points'], None, d['point_labels'], pts2, None, lbl2)

        if self.mode == 'testing':
            sel = d.get('cur_point_indices', slice(None))
            d['points_ri'] = pts[sel][:, -3:].astype(np.int32)
        return d

    def load_padded(self, index):
        d = self[index]
        return self.pad(d), d['filename']

    def pad(self, d):
        return pad_sample(d, self.cfg.RUNTIME.MAX_POINTS_PER_SAMPLE,
                          self.cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE,
                          self.ignore_index, logger=self.logger)

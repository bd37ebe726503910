"""Copy-paste augmentation of rare-class instances (host side, numpy).

A copy of ``openseg3d_tpu/data/instance_augmentation.py``: paste instances
(other-vehicle / motorcyclist / cone by default) from a pickled bank into the
scene with local jitter and rotation, an optional short-axis flip, up to 20
rotation attempts to find an unoccluded on-ground placement (all checked at
once), and a z-snap to the local ground height. Same ``np.random`` draws in
the same order; ``tests/test_torch_data.py`` holds the two equal. The bank is
a pickle that the offline tool ``tools/extract_instances.py`` writes; load
only banks made that way.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


class InstanceAugmentation:
    def __init__(self, instance_path, instance_label_ids=(3, 4, 10),
                 ground_label_ids=(17, 18, 19, 20, 21), add_count=5,
                 random_rotate=True, local_transformation=True, random_flip=True,
                 ignore_index=255):
        self.instance_label_ids = list(instance_label_ids)
        self.ground_label_ids = set(ground_label_ids)
        self.add_count = add_count
        self.random_rotate = random_rotate
        self.local_transformation = local_transformation
        self.random_flip = random_flip
        self.ignore_index = ignore_index
        self.instances = None
        if instance_path and os.path.exists(instance_path):
            with open(instance_path, 'rb') as f:
                self.instances = pickle.load(f)

    # --- geometry helpers -------------------------------------------------
    @staticmethod
    def _rotate_origin(xyz, radians):
        c, s = np.cos(radians), np.sin(radians)
        out = xyz.copy()
        out[:, 0] = xyz[:, 0] * c + xyz[:, 1] * s
        out[:, 1] = -xyz[:, 0] * s + xyz[:, 1] * c
        return out

    def _local_transform(self, xyz, center):
        loc = np.random.normal(scale=0.25, size=(1, 3))
        rot = np.random.uniform(-np.pi / 20, np.pi / 20)
        return self._rotate_origin(xyz - center, rot) + loc + center

    @staticmethod
    def _flip_short_axis(xy, center):
        """Reflect about the instance's short axis through its center."""
        a, b = center[:2] / max(np.linalg.norm(center[:2]), 1e-9)
        a, b = -b, a
        m = np.array([[b * b - a * a, -2 * a * b], [-2 * a * b, a * a - b * b]])
        return (xy - center[:2]) @ m.T + center[:2]

    # --- placement check (vectorized over candidate rotations) -------------
    def _find_placement(self, obj_xyz, gnd_xyz, center, radius):
        """Try 20 random azimuth rotations of `center`; return (angle,
        ground_z) of the first placement that is unoccluded (every non-ground
        point farther than `radius` from the rotated center) and on ground
        (some ground point within 1.2 * radius), or None."""
        n_try = 20 if self.random_rotate else 1
        angles = (np.random.random(n_try) * 2 * np.pi if self.random_rotate
                  else np.zeros(1))
        c, s = np.cos(angles), np.sin(angles)
        cand = np.stack([center[0] * c + center[1] * s,
                         -center[0] * s + center[1] * c,
                         np.full(n_try, center[2])], axis=1)       # [T, 3]
        if obj_xyz.shape[0]:
            d_obj = np.linalg.norm(obj_xyz[None] - cand[:, None], axis=2)
            unoccluded = np.all(d_obj > radius, axis=1)
        else:
            unoccluded = np.ones(n_try, bool)
        if gnd_xyz.shape[0] == 0:
            return None
        d_gnd = np.linalg.norm(gnd_xyz[None] - cand[:, None], axis=2)   # [T, G]
        on_ground = np.min(d_gnd, axis=1) < 1.2 * radius
        viable = np.flatnonzero(unoccluded & on_ground)
        if viable.size == 0:
            return None
        t = int(viable[0])
        ground_z = gnd_xyz[int(np.argmin(d_gnd[t]))][2]
        return float(angles[t]), float(ground_z)

    # --- main entry ---------------------------------------------------------
    def __call__(self, points, point_image_features, labels):
        if self.instances is None:
            if point_image_features is not None:
                return points, point_image_features, labels
            return points, labels

        label_choice = np.random.choice(self.instance_label_ids, self.add_count,
                                        replace=True)
        uni, counts = np.unique(label_choice, return_counts=True)
        for label_id, count in zip(uni, counts):
            bank = self.instances.get(label_id, [])
            if not len(bank):
                continue
            picks = np.random.choice(len(bank), count)
            for idx in picks:
                labeled = labels != self.ignore_index
                is_ground = np.isin(labels, list(self.ground_label_ids))
                obj_xyz = points[:labels.shape[0]][labeled & ~is_ground][:, :3]
                gnd_xyz = points[:labels.shape[0]][labeled & is_ground][:, :3]

                inst = bank[idx]
                ipts = np.array(inst['cluster_points'], copy=True)
                iheight = inst['cluster_height']
                xyz = ipts[:, :3]
                feat = ipts[:, 3:].copy()
                if feat.shape[1] >= 2:
                    feat[:, 0] = 0                       # range column reset
                    feat[:, 1] = np.tanh(feat[:, 1])     # intensity normalize

                center = xyz.mean(axis=0)
                if self.local_transformation:
                    xyz = self._local_transform(xyz, center)
                if self.random_flip and np.random.choice(5) == 3:
                    xyz[:, :2] = self._flip_short_axis(xyz[:, :2], center)

                center = xyz.mean(axis=0)
                radius = float(np.max(np.linalg.norm(xyz - center, axis=1)))
                placement = self._find_placement(obj_xyz, gnd_xyz, center, radius)
                if placement is None:
                    continue
                angle, ground_z = placement
                xyz = self._rotate_origin(xyz, angle)
                xyz[:, 2] += (ground_z + iheight) - center[2]

                add = np.concatenate([xyz, feat], axis=1).astype(points.dtype)
                add = add[:, :points.shape[1]]   # bank dims may exceed dim_point
                points = np.concatenate([points, add], axis=0)
                labels = np.concatenate(
                    [labels, np.full(add.shape[0], label_id, labels.dtype)])
                if point_image_features is not None:
                    point_image_features = np.concatenate(
                        [point_image_features,
                         np.zeros((add.shape[0], point_image_features.shape[1]),
                                  point_image_features.dtype)], axis=0)

        if point_image_features is not None:
            return points, point_image_features, labels
        return points, labels

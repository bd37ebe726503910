"""PolarMix scene mixing (host side, numpy).

A copy of ``openseg3d_tpu/data/polarmix.py``: (a) with p=0.5 swap an azimuth
sector between two scans, (b) always rotate-copy-paste all instance-class
points of scan 2 at the configured extra angles. Same ``np.random`` draws in
the same order; ``tests/test_torch_data.py`` holds the two equal.
"""

from __future__ import annotations

import numpy as np


def _yaw(points):
    return -np.arctan2(points[:, 1], points[:, 0])


def swap_sector(points1, labels1, points2, labels2, start, end,
                feats1=None, feats2=None):
    """Replace scan1's [start, end) azimuth sector with scan2's."""
    in1 = (_yaw(points1) > start) & (_yaw(points1) < end)
    in2 = (_yaw(points2) > start) & (_yaw(points2) < end)
    pts = np.concatenate([points1[~in1], points2[in2]])
    lbl = np.concatenate([labels1[~in1], labels2[in2]])
    if feats1 is not None and feats2 is not None:
        f = np.concatenate([feats1[~in1], feats2[in2]])
        return pts, f, lbl
    return pts, lbl


def rotate_copy(points, labels, instance_classes, angles, feats=None):
    """Collect all instance-class points, then stack the original + one
    z-rotated copy per angle (polarmix.py:28-64)."""
    m = np.isin(labels, list(instance_classes))
    pi, li = points[m], labels[m]
    fi = feats[m] if feats is not None else None
    out_p, out_l = [pi], [li]
    out_f = [fi] if fi is not None else None
    for angle in angles:
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=points.dtype)
        p = pi.copy()
        p[:, :3] = pi[:, :3] @ rot
        out_p.append(p)
        out_l.append(li)
        if out_f is not None:
            out_f.append(fi)
    pts = np.concatenate(out_p)
    lbl = np.concatenate(out_l)
    if out_f is not None:
        return pts, np.concatenate(out_f), lbl
    return pts, lbl


class PolarMix:
    def __init__(self, instance_classes, rot_angle_range):
        self.instance_classes = list(instance_classes)
        self.rot_angle_range = list(rot_angle_range)

    def __call__(self, points1, feats1, labels1, points2, feats2, labels2):
        with_f = feats1 is not None and feats2 is not None
        out = (points1, feats1, labels1) if with_f else (points1, labels1)

        if np.random.random() < 0.5:
            alpha = (np.random.random() - 1) * np.pi
            beta = alpha + np.pi
            if with_f:
                out = swap_sector(points1, labels1, points2, labels2, alpha, beta,
                                  feats1, feats2)
            else:
                out = swap_sector(points1, labels1, points2, labels2, alpha, beta)

        if with_f:
            p, f, l = out
            cp, cf, cl = rotate_copy(points2, labels2, self.instance_classes,
                                     self.rot_angle_range, feats2)
            return (np.concatenate([p, cp]), np.concatenate([f, cf]),
                    np.concatenate([l, cl]))
        p, l = out
        cp, cl = rotate_copy(points2, labels2, self.instance_classes,
                             self.rot_angle_range)
        return np.concatenate([p, cp]), np.concatenate([l, cl])

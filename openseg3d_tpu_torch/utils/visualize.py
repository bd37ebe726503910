"""Colored point and voxel cloud dumps (numpy only).

Counterpart of ``openseg3d_tpu/utils/visualize.py``, whose module is copied
here because the port imports nothing of the JAX package: ASCII .pcd v0.7
files with packed float rgb, byte-equal to that writer's
(``tests/test_torch_rest.py``), without open3d.
"""

from __future__ import annotations

import os

import numpy as np


def write_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """ASCII PCD v0.7 with packed float rgb."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = xyz.shape[0]
    rgb = rgb.astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    packed_f = packed.view(np.float32)
    header = (
        '# .PCD v0.7 - Point Cloud Data file format\n'
        'VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n'
        f'COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n'
        f'POINTS {n}\nDATA ascii\n')
    with open(path, 'w') as f:
        f.write(header)
        for i in range(n):
            f.write(f'{xyz[i, 0]:.4f} {xyz[i, 1]:.4f} {xyz[i, 2]:.4f} {packed_f[i]:.8e}\n')


def _colors(palette, labels, ignore_index=255):
    pal = np.asarray(palette, np.int64)
    lab = np.asarray(labels)
    safe = np.clip(lab, 0, len(pal) - 1)
    c = pal[safe]
    c[lab == ignore_index] = 0
    return c


def draw_points(palette, sample: dict, save_dir: str) -> str:
    """Dump one sample's labeled points to <save_dir>/<filename>.pcd."""
    pts = np.asarray(sample['points'])
    labels = sample.get('point_labels', np.zeros(pts.shape[0], np.int64))
    path = os.path.join(save_dir, f"{sample.get('filename', 'points')}.pcd")
    write_pcd(path, pts[:, :3], _colors(palette, labels))
    return path


def draw_voxels(palette, voxel_size, point_cloud_range, sample: dict,
                save_dir: str) -> str:
    """Dump voxel centers colored by voxel label."""
    coords = np.asarray(sample['voxel_coords'])          # [M, 3] zyx
    labels = sample.get('voxel_labels', np.zeros(coords.shape[0], np.int64))
    vs = np.asarray(voxel_size, np.float32)
    origin = np.asarray(point_cloud_range[:3], np.float32)
    centers = (coords[:, ::-1].astype(np.float32) + 0.5) * vs + origin
    path = os.path.join(save_dir, f"{sample.get('filename', 'voxels')}.pcd")
    write_pcd(path, centers, _colors(palette, labels))
    return path

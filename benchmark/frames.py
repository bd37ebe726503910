"""The benchmark's frames: a ring of synthetic Waymo-like LiDAR sweeps drawn
from the run's seed.

``waymo_like_cloud`` is a frozen copy of the port's
``data/synthetic.make_waymo_like_cloud`` (64 elevation beams swept over
azimuth columns, each ray ending on the ground plane or on one of 200
vertical obstacles), written for numpy's ``Generator`` so that any seed a
run is given, however large, seeds it (``standard_normal`` stands where the
original calls ``RandomState.randn``). A traffic mix's ``frames`` entry
sets the ring: ``count`` frames whose point counts are spread evenly over
``[min_points, max_points]`` (a stratified uniform draw: every seed serves
the same sizes, in its own order), labels uniform over ``num_classes``.
"""

from __future__ import annotations

import numpy as np


def seed_sequence(seed: int, purpose: str) -> np.random.SeedSequence:
    """A SeedSequence for one purpose of one run: any whole number seeds it,
    negative ones and ones past 64 bits included."""
    return np.random.SeedSequence([seed % 2 ** 64, *purpose.encode()])


def waymo_like_cloud(rng: np.random.Generator, n_points: int) -> np.ndarray:
    """[n_points, 6] float32: x, y, z and three standard-normal features."""
    sensor_h = 2.0
    n_beams = 64
    n_cols = max(n_points // n_beams, 1)
    elev = np.linspace(np.deg2rad(-18.0), np.deg2rad(2.5), n_beams)
    az = np.linspace(-np.pi, np.pi, n_cols, endpoint=False)
    az = az[None, :] + rng.normal(0, 1e-3, (n_beams, n_cols))
    el = np.broadcast_to(elev[:, None], (n_beams, n_cols)).copy()

    with np.errstate(divide='ignore'):
        r_ground = np.where(el < -1e-3, sensor_h / np.tan(-el), 75.0)
    r = np.minimum(r_ground, 74.0)
    n_obs = 200
    ob_az = rng.uniform(-np.pi, np.pi, n_obs)
    ob_w = rng.uniform(0.02, 0.15, n_obs)
    ob_r = rng.uniform(4.0, 70.0, n_obs)
    ob_h = rng.uniform(0.5, 5.0, n_obs)
    for i in range(n_obs):
        hit = (np.abs((az - ob_az[i] + np.pi) % (2 * np.pi) - np.pi) < ob_w[i])
        z_at = sensor_h + np.tan(el) * ob_r[i]
        hit &= (r > ob_r[i]) & (z_at < ob_h[i] - 1.9)
        r = np.where(hit, ob_r[i] * rng.uniform(0.98, 1.0), r)

    r = (r * rng.uniform(0.995, 1.005, r.shape)).clip(1.5, 75.0)
    x = r * np.cos(el) * np.cos(az)
    y = r * np.cos(el) * np.sin(az)
    z = sensor_h + r * np.sin(el) - 1.9
    xyz = np.stack([x, y, z], -1).reshape(-1, 3)
    xyz = xyz[:n_points]
    if xyz.shape[0] < n_points:
        xyz = np.concatenate([xyz, xyz[:n_points - xyz.shape[0]] + 0.05])
    feats = rng.standard_normal((n_points, 3)).astype(np.float32)
    return np.concatenate([xyz.astype(np.float32), feats], 1)


def ring_sizes(spec: dict) -> list[int]:
    """The point counts of the ring, smallest first."""
    lo, hi, n = int(spec['min_points']), int(spec['max_points']), int(spec['count'])
    if n == 1:
        return [lo]
    return [lo + (hi - lo) * i // (n - 1) for i in range(n)]


def draw_ring(spec: dict, seed: int) -> list[dict]:
    """The ring of a run: [{'points' [n, 6] float32, 'labels' [n] int32}],
    in the order the seed gives."""
    ss = seed_sequence(seed, 'frames')
    order_rng, *frame_seeds = [np.random.default_rng(s) for s in ss.spawn(int(spec['count']) + 1)]
    sizes = [ring_sizes(spec)[i] for i in order_rng.permutation(int(spec['count']))]
    ring = []
    for n, rng in zip(sizes, frame_seeds):
        points = waymo_like_cloud(rng, n)
        labels = rng.integers(0, int(spec['num_classes']), n).astype(np.int32)
        ring.append({'points': points, 'labels': labels})
    return ring

"""Verify that the bench frames lose no voxel to a capacity (numpy only).

    python -m openseg3d_tpu_torch.tools.verify_capacities [--frames 4] [--max_voxels 98304]

Counterpart of the JAX package's ``tools/verify_capacities.py``, with its
flags and its printed lines. For each bench frame (the JAX bench's
synthetic generator, ``data.synthetic.make_waymo_like_cloud``, seed 0) it
checks that:
  * the voxelizer's output fits MAX_VOXELS_PER_SAMPLE;
  * every stage's dilated downsample output fits its STAGE_CAPACITY_RATIOS
    capacity (``models.backbones.sparse_unet.stage_capacities``);
  * every (stage, shift, level) distinct-window count fits the
    WINDOW_BUCKET_FRACTIONS window capacity W_l (rounded up to
    ``ops.attention.attention_group``, as ``ops.window.make_level_specs``
    rounds it), and no window exceeds its bucket's max_tokens (the top
    bucket's 800-token drop cap never binds).
Runs on the host: no device, no kernel.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='Check the bench frames against the capacities')
    ap.add_argument('--cfg_file', default='configs/waymo_one_sweep.yaml')
    ap.add_argument('--frames', type=int, default=4)
    ap.add_argument('--n_points', type=int, default=163840)
    ap.add_argument('--max_voxels', type=int, default=98304)
    ap.add_argument('--seed', type=int, default=0, help='the bench uses seed 0')
    return ap.parse_args(argv)


def dilated_downsample(coords, shape):
    """The output sites of a kernel-3, stride-2, padding-1 sparse conv over
    coords [V, 3] zyx in a grid of `shape`, and the output grid."""
    gz, gy, gx = shape
    oz, oy, ox = (gz - 1) // 2 + 1, (gy - 1) // 2 + 1, (gx - 1) // 2 + 1
    outs = []
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                off = (coords + 1) % 2 + 2 * np.array([cz, cy, cx])
                ok = (off < 3).all(1)
                t = (coords[ok] + 1 - off[ok]) // 2
                inb = ((t >= 0).all(1) & (t[:, 0] < oz) & (t[:, 1] < oy)
                       & (t[:, 2] < ox))
                outs.append(t[inb])
    return np.unique(np.concatenate(outs), axis=0), (oz, oy, ox)


def window_counts(coords, shape, wshape, shift):
    """Voxels per distinct window of coords [V, 3] zyx (``ops.window.window_coords``'s ids)."""
    gz, gy, gx = shape
    wx, wy, wz = wshape
    sz = 0 if gz == wz else (wz // 2 if shift else 0)
    sx = wx // 2 if shift else 0
    sy = wy // 2 if shift else 0
    z = coords[:, 0] + sz
    y = coords[:, 1] + sy
    x = coords[:, 2] + sx
    nwy = -(-gy // wy) + 1
    nwz = -(-gz // wz) + 1
    win = (x // wx) * (nwy * nwz) + (y // wy) * nwz + (z // wz)
    _, cnts = np.unique(win, return_counts=True)
    return cnts


def main(argv=None) -> dict:
    """Checks, prints a line per frame and stage (and per violation) and the
    result; returns {'violations': their count, 'voxels': per frame, each
    stage's voxel count}."""
    args = parse_args(argv)
    from ..config import cfg_from_file
    from ..core.voxelizer import VoxelGenerator
    from ..data.synthetic import make_waymo_like_cloud
    from ..models.backbones.sparse_unet import stage_capacities
    from ..ops.attention import attention_group

    cfg = cfg_from_file(args.cfg_file, overrides={
        'RUNTIME': {'MAX_POINTS_PER_SAMPLE': args.n_points,
                    'MAX_VOXELS_PER_SAMPLE': args.max_voxels}})
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    caps = stage_capacities(args.max_voxels, cfg.RUNTIME.STAGE_CAPACITY_RATIOS)
    fracs = cfg.RUNTIME.WINDOW_BUCKET_FRACTIONS
    wshape = cfg.MODEL.WINDOW_SHAPE
    gx, gy, gz = (int(v) for v in vg.grid_size)

    rng = np.random.RandomState(args.seed)
    failures, voxels = 0, []
    for fi in range(args.frames):
        pts = make_waymo_like_cloud(rng, args.n_points)
        coords, _ = vg.generate(pts)
        coords = coords.astype(np.int64)
        shape = (gz, gy, gx)
        voxels.append([])
        for s in range(4):
            v = len(coords)
            voxels[-1].append(v)
            ok = v <= caps[s]
            failures += not ok
            print(f'frame {fi} stage {s+1}: voxels {v} / cap {caps[s]} '
                  f'{"OK" if ok else "DROP!"}', flush=True)
            info = cfg.MODEL.BATCHING_INFO[s]
            keys = sorted(info.keys(), key=int)
            for shift in (0, 1):
                cnts = window_counts(coords, shape, wshape, shift)
                for li, k in enumerate(keys):
                    t = info[k]['max_tokens']
                    lo, hi = info[k]['batching_range']
                    m = (cnts >= lo) & (cnts < hi)
                    n_win = int(m.sum())
                    w_cap = max(1, int(math.ceil(fracs[s][li] * caps[s] / t)))
                    g = attention_group(t)
                    w_cap = (w_cap + g - 1) // g * g
                    tok_drop = int(np.maximum(cnts[m] - t, 0).sum())
                    if n_win > w_cap or tok_drop:
                        failures += 1
                        print(f'  stage {s+1} shift {shift} L{li} T={t}: '
                              f'windows {n_win} / {w_cap}, token drops '
                              f'{tok_drop}  DROP!', flush=True)
            if s < 3:
                coords, shape = dilated_downsample(coords, shape)
    print('RESULT:', 'ZERO capacity drops' if failures == 0
          else f'{failures} capacity violations')
    return {'violations': failures, 'voxels': voxels}


if __name__ == '__main__':
    sys.exit(0 if main()['violations'] == 0 else 1)

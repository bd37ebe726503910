"""Measure per-stage voxel occupancy and window-bucket usage, and suggest
RUNTIME.STAGE_CAPACITY_RATIOS / RUNTIME.WINDOW_BUCKET_FRACTIONS.

    python -m openseg3d_tpu_torch.tools.measure_capacities --frames 16 --margin 1.25
    python -m openseg3d_tpu_torch.tools.measure_capacities --data_dir /data/waymo

Counterpart of the JAX package's ``tools/measure_capacities.py``, with its
flags and its printed suggestions, plus ``--device`` (default ``cuda``). The
port keeps the JAX package's static capacities, and this tool sizes them
from data: it runs the structure pipeline (voxelize on the host, then 3
stride-2 downsamples, ``ops.sparse_conv.build_downsample``, and the
dual-shift window ids of every stage, ``ops.window.window_coords``) on the
device over N frames, at capacities generous enough that nothing is cut
(``MEASURE_CAPACITY_FACTORS`` x --max_voxels), records the true voxel count
of every stage and the distinct windows of every (stage, shift, level),
and prints config-ready suggestions at a safety margin.

Frames come from the JAX bench's synthetic Waymo-like beam model
(``data.synthetic.make_waymo_like_cloud``, RandomState(--seed)) by default,
or from a parsed Waymo directory (``lidar/*.npy``, ``tools/waymo_parser.py``'s
layout) with --data_dir.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

# measurement capacities per stage, in units of --max_voxels: generous, so
# that no stage is cut
MEASURE_CAPACITY_FACTORS = (1, 2, 2, 1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='Size the RUNTIME capacities from data')
    ap.add_argument('--cfg_file', default='configs/waymo_one_sweep.yaml')
    ap.add_argument('--frames', type=int, default=8)
    ap.add_argument('--n_points', type=int, default=163840)
    ap.add_argument('--max_voxels', type=int, default=98304)
    ap.add_argument('--margin', type=float, default=1.25)
    ap.add_argument('--data_dir', default='',
                    help='parsed Waymo dir (lidar/*.npy); default = synthetic')
    ap.add_argument('--seed', type=int, default=1)
    ap.add_argument('--device', default='cuda',
                    help="torch device of the structure pipeline: 'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def frame_counts(coords: np.ndarray, spec, max_voxels: int, device):
    """The structure of one voxelized frame (coords [V, 3] zyx) on `device`:
    (true voxel count of each of the 4 stages, windows [4, 2, L] and capped
    tokens [4, 2, L] of each (stage, shift, level)), L the levels of stage 1."""
    import torch

    from ..ops.sparse_conv import SparseTensor, build_downsample
    from ..ops.window import window_coords

    caps = [max_voxels * m for m in MEASURE_CAPACITY_FACTORS]
    n_levels = len(spec.batching_info[0])
    windows = np.zeros((4, 2, n_levels), np.int64)
    tokens = np.zeros((4, 2, n_levels), np.int64)
    pad = np.full((caps[0] - coords.shape[0], 3), -1, np.int32)
    cur = torch.from_numpy(np.concatenate([coords.astype(np.int32), pad])[None]).to(device)
    occupancy, stage_coords, shapes = [coords.shape[0]], [cur[0]], [spec.spatial_shape]
    st = SparseTensor(features=None, coords=cur, spatial_shape=spec.spatial_shape)
    for s in range(3):
        plan = build_downsample(st, out_capacity=caps[s + 1])
        occupancy.append(int(plan.num_out[0]))
        st = SparseTensor(features=None, coords=plan.out_coords, spatial_shape=plan.out_shape)
        stage_coords.append(plan.out_coords[0])
        shapes.append(plan.out_shape)
    for s in range(4):
        cc = stage_coords[s]
        valid = cc[:, 0] >= 0
        for shift in (0, 1):
            win, _ = window_coords(cc, valid, shapes[s], spec.window_shape, bool(shift))
            _, cnts = torch.unique(win[valid], return_counts=True)
            cnts = cnts.cpu().numpy()
            for li, (_, (t, lo, hi)) in enumerate(spec.batching_info[s]):
                m = (cnts >= lo) & (cnts < hi)
                windows[s, shift, li] = int(m.sum())
                tokens[s, shift, li] = int(np.minimum(cnts[m], t).sum())
    return occupancy, windows, tokens


def main(argv=None) -> dict:
    """Measures, prints the suggestions and returns them with the running
    maxima: {'occupancy': per stage, 'windows' and 'tokens': [4, L] over
    frames and shifts, 'ratios', 'fractions'}."""
    args = parse_args(argv)
    from ..config import cfg_from_file
    from ..core.voxelizer import VoxelGenerator
    from ..data.synthetic import make_waymo_like_cloud
    from ..models.segmentors.common import ModelSpec
    from .train import resolve_device

    device = resolve_device(args.device)
    cfg = cfg_from_file(args.cfg_file, overrides={
        'RUNTIME': {'MAX_POINTS_PER_SAMPLE': args.n_points,
                    'MAX_VOXELS_PER_SAMPLE': args.max_voxels}})
    spec = ModelSpec.from_config(cfg)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    rng = np.random.RandomState(args.seed)
    if args.data_dir:
        frames = sorted(glob.glob(os.path.join(args.data_dir, 'lidar', '*.npy')))[:args.frames]
        load = lambda f: np.load(f)[:, :6].astype(np.float32)
    else:
        frames = list(range(args.frames))
        load = lambda _: make_waymo_like_cloud(rng, args.n_points)

    n_levels = len(spec.batching_info[0])
    occ_max = [0, 0, 0, 0]
    win_max = np.zeros((4, n_levels), np.int64)   # max over frames and shifts
    tok_max = np.zeros((4, n_levels), np.int64)
    for fi, fr in enumerate(frames):
        coords, _ = vg.generate(load(fr))
        occupancy, windows, tokens = frame_counts(coords, spec, args.max_voxels, device)
        occ_max = [max(a, b) for a, b in zip(occ_max, occupancy)]
        win_max = np.maximum(win_max, windows.max(axis=1))
        tok_max = np.maximum(tok_max, tokens.max(axis=1))
        print(f'frame {fi}: stage occ '
              f'{[round(o / args.max_voxels, 3) for o in occ_max]} (running max)', flush=True)

    print('\n== suggestions (margin %.2f, MAX_VOXELS=%d) ==' % (args.margin, args.max_voxels))
    ratios = [round(args.margin * o / args.max_voxels, 2) for o in occ_max]
    ratios[0] = max(ratios[0], 1.0)   # stage 1 is the voxelizer contract
    print('RUNTIME.STAGE_CAPACITY_RATIOS:', ratios)
    caps = [max(128, int(-(-args.max_voxels * r // 128) * 128)) for r in ratios]
    fracs = []
    for s in range(4):
        row = []
        for li, (_, (t, lo, hi)) in enumerate(spec.batching_info[s]):
            w_need = args.margin * win_max[s, li]
            row.append(round(max(w_need * t / caps[s], 0.02), 2))
        fracs.append(row)
    print('RUNTIME.WINDOW_BUCKET_FRACTIONS:')
    for s in range(4):
        print(f'  {fracs[s]},   # stage {s+1}: max windows {list(win_max[s])}, '
              f'max capped tokens {list(tok_max[s])}', flush=True)
    return {'occupancy': occ_max, 'windows': win_max.tolist(), 'tokens': tok_max.tolist(),
            'ratios': ratios, 'fractions': [[float(f) for f in row] for row in fracs]}


if __name__ == '__main__':
    main()

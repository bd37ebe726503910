"""End-to-end segmentation throughput of the port on one GPU: one JSON line.

    python -m openseg3d_tpu_torch.bench                       # Segformer eval forward
    python -m openseg3d_tpu_torch.bench --mode train          # the train step
    python -m openseg3d_tpu_torch.bench --mode train_fwd --segmentor spnet

Counterpart of the JAX package's ``bench.py``, with its flags and defaults
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain versions and
times the CPU, for tests). The frame is bench.py's: its synthetic Waymo-like
beam model from ``RandomState(0)``, drawn in the same order sample by
sample (multi-sweep: ego-shifted sweeps with a timestamp column, cut to
``--n_points``; cylinder: (rho, phi, z, x, y, features); labels voted over
the current points; image features drawn after the labels), voxelized and
padded on the host: the batch equals the JAX bench's array for array. The
weights are random, seeded (``weights.init_weights``).

Modes: ``infer`` is ``engine.make_forward``; ``train_fwd`` the train-mode
forward and ``engine.compute_loss`` under ``torch.no_grad`` (the JAX bench's
``fstep``, no gradient); ``train`` is ``engine.make_train_step``.

Timing: the kernels are built first (``build_s``), the first call is timed
alone (``first_step_s``, the counterpart of the JAX bench's ``compile_s``),
then ``--iters`` calls run back to back between two synchronisations and
``step_ms`` is their mean. The line adds the card's name and power limit as
``nvidia-smi`` reports them (null on the CPU) and the launches per step of
each hand-written kernel, from the wrappers' counters.

Left out of the JAX bench's line: ``v5e8_projection_vs_baseline``, a
projection to eight TPU chips; and its ``--scan_unroll`` flag, an XLA
compile option that eager PyTorch has no counterpart of.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

# an estimate, not a measurement: the reference publishes no throughput;
# BASELINE.md derives ~10 frames/s at 165k points on one A100
A100_BASELINE_POINTS_PER_SEC = 1.65e6


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='End-to-end throughput of the port, one JSON line')
    ap.add_argument('--batch_size', type=int, default=1)
    ap.add_argument('--n_points', type=int, default=163840)
    ap.add_argument('--iters', type=int, default=25)
    ap.add_argument('--mode', choices=['infer', 'train', 'train_fwd'], default='infer')
    ap.add_argument('--segmentor', default='segformer')
    ap.add_argument('--max_voxels', type=int, default=98304)
    ap.add_argument('--stage_ratios', type=str, default='',
                    help='comma-separated RUNTIME.STAGE_CAPACITY_RATIOS override, for '
                         'capacity-cost bisection')
    ap.add_argument('--image_feature', action='store_true',
                    help='enable DATASET.USE_IMAGE_FEATURE (DeepFusion cross-attention + '
                         'KNN) with random 28-dim features')
    ap.add_argument('--cfg_file', default='configs/waymo_one_sweep.yaml')
    ap.add_argument('--losses', default='',
                    help='override MODEL.LOSSES for train-mode ablation, e.g. "ce" or '
                         '"ohem_ce,lovasz" (cost attribution of the loss block)')
    ap.add_argument('--device', default='cuda',
                    help="torch device: 'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def bench_config(args):
    """The config the JAX bench builds from the same flags."""
    from .config import cfg_from_file
    runtime = {'MAX_POINTS_PER_SAMPLE': args.n_points, 'MAX_VOXELS_PER_SAMPLE': args.max_voxels}
    if args.stage_ratios:
        runtime['STAGE_CAPACITY_RATIOS'] = [float(x) for x in args.stage_ratios.split(',')]
    overrides = {'MODEL': {'SEGMENTOR': args.segmentor}, 'RUNTIME': runtime}
    if args.image_feature:
        overrides['DATASET'] = {'USE_IMAGE_FEATURE': True}
    cfg = cfg_from_file(args.cfg_file, overrides=overrides)
    if args.losses:
        # wholesale replacement: the strict merge cannot bring in new loss names
        cfg = cfg.unfrozen_copy()
        cfg.MODEL.LOSSES = {name: 1.0 for name in args.losses.split(',')}
        cfg = cfg.freeze()
    return cfg


def bench_batch(cfg, batch_size: int, n_points: int, max_voxels: int,
                image_feature: bool = False):
    """(padded numpy batch, live voxels per sample): the JAX bench's frames,
    drawn from RandomState(0) in its order (``bench.py:141-184``)."""
    from .core.voxelizer import VoxelGenerator, majority_voxel_labels
    from .data.batch import collate_padded, pad_sample
    from .data.synthetic import make_waymo_like_cloud
    from .utils.pointops import cart2polar

    rng = np.random.RandomState(0)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    multi = bool(cfg.DATASET.USE_MULTI_SWEEPS)
    n_cur = n_points // cfg.DATASET.NUM_SWEEPS if multi else n_points
    samples = []
    for _ in range(batch_size):
        if multi:
            # NUM_SWEEPS ego-shifted copies of a frame; column 3 the timestamp
            # delta (0 for the current sweep)
            sweeps = []
            for si in range(cfg.DATASET.NUM_SWEEPS):
                sw = make_waymo_like_cloud(rng, n_cur)
                sw[:, :2] += 0.4 * si
                sw[:, 3] = 0.1 * si
                sweeps.append(sw)
            pts = np.concatenate(sweeps)[:n_points]
            cur_idx = np.arange(n_cur)
        else:
            pts = make_waymo_like_cloud(rng, n_points)
        if cfg.DATASET.USE_CYLINDER:
            pts = np.concatenate([cart2polar(pts), pts[:, :2], pts[:, 3:]],
                                 axis=1).astype(np.float32)
        coords, ids = vg.generate(pts)
        labels = rng.randint(0, 22, n_cur)
        # voxel labels are voted over the current points only, as the dataset does
        vote_ids = ids[cur_idx] if multi else ids
        sample = dict(points=pts, voxel_coords=coords, point_voxel_ids=ids, point_labels=labels,
                      voxel_labels=majority_voxel_labels(vote_ids, labels, coords.shape[0]))
        if multi:
            sample['cur_point_indices'] = cur_idx
        if image_feature:
            sample['point_image_features'] = rng.randn(
                n_cur, cfg.DATASET.DIM_IMAGE_FEATURE).astype(np.float32)
        samples.append(sample)
    n_voxels = [int(s['voxel_coords'].shape[0]) for s in samples]
    return collate_padded([pad_sample(s, n_points, max_voxels) for s in samples]), n_voxels


def card_identity(device: torch.device):
    """(name, power limit in W) of the card as nvidia-smi reports them;
    (None, None) on the CPU."""
    if device.type != 'cuda':
        return None, None
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
                          f'--id={index}'], capture_output=True, text=True, check=True)
    name, limit = (part.strip() for part in smi.stdout.strip().rsplit(',', 1))
    try:
        return name, float(limit.split()[0])
    except ValueError:          # '[N/A]': no limit reported
        return name, None


def kernel_counters() -> dict:
    """{name: wrapper} of the hand-written kernels; each wrapper's
    ``.launches`` counts where it launches its kernel."""
    from .ops.attention import (fused_window_attention, window_attention_packed,
                                window_attention_train_backward,
                                window_attention_train_forward)
    from .ops.knn import nearest_point
    return {f.__name__: f for f in (window_attention_packed, window_attention_train_forward,
                                    window_attention_train_backward, nearest_point,
                                    fused_window_attention)}


def make_step(mode: str, cfg, model, spec, batch, device):
    """A call that runs one step of `mode` and returns a tensor of it."""
    from .engine import TrainState, compute_loss, make_forward, make_train_step, step_generator
    from .models.losses import build_criterion
    from .models.optim import build_optimizer, build_schedule

    if mode == 'infer':
        forward = make_forward(model)
        return lambda: forward(batch)
    if mode == 'train_fwd':
        criterion = build_criterion(cfg)
        aux_w = float(cfg.MODEL.AUX_LOSS_WEIGHT)

        def forward_and_loss():
            model.train()
            with torch.no_grad():
                out = model(batch, rng=step_generator(0, 0, device))
                return compute_loss(out, batch, criterion, spec, aux_w)
        return forward_and_loss
    state = TrainState(model, build_optimizer(cfg, model.parameters()),
                       build_schedule(cfg, 30, 1000))
    train_step = make_train_step(cfg, spec)
    return lambda: train_step(state, batch, 0)[1]['loss']


def main(argv=None) -> dict:
    """Runs the benchmark, prints its JSON line and returns it as a dict."""
    args = parse_args(argv)
    from .data.batch import to_device
    from .engine import build_segmentor
    from .ops import _build
    from .tools.train import resolve_device
    from .weights import init_weights

    device = resolve_device(args.device)
    cfg = bench_config(args)
    batch, n_voxels = bench_batch(cfg, args.batch_size, args.n_points, args.max_voxels,
                                  args.image_feature)
    batch = to_device(batch, device)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    build_s = None
    if device.type == 'cuda':
        t0 = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t0
    model, spec = build_segmentor(cfg, device)
    init_weights(model, torch.Generator().manual_seed(0))
    step = make_step(args.mode, cfg, model, spec, batch, device)

    counters = kernel_counters()
    before = {name: f.launches for name, f in counters.items()}
    sync()
    t0 = time.perf_counter()
    step()
    sync()
    first_step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step()
    sync()
    med = (time.perf_counter() - t0) / args.iters
    calls = args.iters + 1
    launches = {name: (f.launches - before[name]) / calls for name, f in counters.items()}

    pts_per_sec = args.batch_size * args.n_points / med
    gpu, power_limit_w = card_identity(device)
    result = {
        'metric': f'{args.segmentor}{"+deepfusion" if args.image_feature else ""} '
                  f'end-to-end {args.mode} throughput '
                  f'(single chip, {args.n_points} pts/frame, '
                  f'voxels={n_voxels}, step={med * 1e3:.1f}ms)',
        'value': round(pts_per_sec / 1e6, 4),
        'unit': 'Mpoints/sec',
        # single-card rate over the estimated single-A100 rate of the
        # reference (an estimate: BASELINE.md)
        'vs_baseline': round(pts_per_sec / A100_BASELINE_POINTS_PER_SEC, 3),
        'step_ms': round(med * 1e3, 3),
        'first_step_s': round(first_step_s, 3),
        'build_s': None if build_s is None else round(build_s, 3),
        'gpu': gpu,
        'power_limit_w': power_limit_w,
        'device': str(device),
        'launches_per_step': {k: int(v) if v == int(v) else v for k, v in launches.items()},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()

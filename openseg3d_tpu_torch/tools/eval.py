"""Offline evaluation with test-time augmentation, on one GPU (or on the CPU
with ``--device cpu``).

    python -m openseg3d_tpu_torch.tools.eval --cfg_file configs/synthetic_accuracy.yaml \
        --synthetic --save_dir runs/synth_torch [--no_tta] [--tta_batch 2 --tta_workers 4]

Counterpart of ``tools/eval.py``, with its flags plus ``--device`` (default
``cuda``): the newest ``epoch_N.pt`` of the save directory (random weights
if there is none), the validation split, and either one forward per frame
(``--no_tta``) or the 36-variant host TTA (3 scales x 3 angles x flip_x x
flip_y, ``data/test_time_aug.MultiScaleFlipAug``), ``--tta_batch`` variants
per forward, prepared by ``--tta_workers`` processes; or, with
``--tta_device``, the same 36 variants transformed and voxelized where the
model runs (``tta_device_group``; cartesian single-sweep configs without
image features), so that the host touches a frame once. The softmax sums
stay on the device; one argmax per frame comes back.
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch

from .train import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Evaluate a 3d segmentor')
    p.add_argument('--cfg_file', type=str, default=None)
    p.add_argument('--data_dir', type=str, default=None)
    p.add_argument('--save_dir', type=str, required=True,
                   help='directory holding the epoch_N.pt checkpoints')
    p.add_argument('--log_iter_interval', default=10, type=int)
    p.add_argument('--no_tta', action='store_true')
    p.add_argument('--tta_batch', default=2, type=int,
                   help='TTA variants batched per forward (a divisor of 36)')
    p.add_argument('--synthetic', action='store_true')
    p.add_argument('--synthetic_frames', default=8, type=int)
    p.add_argument('--tta_workers', default=0, type=int,
                   help='host processes preparing TTA variants ahead of the '
                        'device (0 = inline)')
    p.add_argument('--tta_device', action='store_true',
                   help='TTA transforms and voxelization on the device (ops/voxelize), '
                        'the raw cloud cut to MAX_POINTS_PER_SAMPLE first; cartesian '
                        'single-sweep configs without image features')
    p.add_argument('--device', default='cuda',
                   help="torch device to evaluate on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the evaluation, logging to the console and to eval.log in the
    save directory. Returns the metric ('mIOU', 'IOU') and the confusion
    histogram ('hist', rows = ground truth)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    from ..utils.logging import get_root_logger, log_to_file
    with log_to_file(get_root_logger(), os.path.join(args.save_dir, 'eval.log')) as logger:
        return _evaluate(args, device, logger)


def _evaluate(args, device, logger) -> dict:
    from ..config import cfg_from_file
    from ..core.metrics import IOUMetric
    from ..data.batch import collate_padded, to_device
    from ..data.test_time_aug import MultiScaleFlipAug
    from ..engine import TrainState, build_segmentor, make_forward
    from ..models.optim import build_optimizer, build_schedule
    from ..utils.checkpoint import latest_checkpoint, restore_checkpoint
    from ..weights import init_weights

    cfg = cfg_from_file(args.cfg_file)
    tta_device = args.tta_device and not args.no_tta
    if tta_device and (cfg.DATASET.USE_MULTI_SWEEPS or cfg.DATASET.USE_CYLINDER
                       or cfg.DATASET.USE_IMAGE_FEATURE):
        raise ValueError('--tta_device supports cartesian single-sweep configs without image '
                         'features (the host TTA path covers the rest)')
    if args.synthetic:
        from ..data.synthetic import SyntheticDataset
        dataset_factory = functools.partial(
            SyntheticDataset, cfg, args.synthetic_frames, mode='validation')
    else:
        from ..data.waymo_dataset import WaymoDataset
        dataset_factory = functools.partial(WaymoDataset, cfg, args.data_dir, 'validation')
    dataset = dataset_factory()

    model, spec = build_segmentor(cfg, device)
    init_weights(model, torch.Generator().manual_seed(0))
    latest = latest_checkpoint(args.save_dir)
    if latest:
        state = TrainState(model, build_optimizer(cfg, model.parameters()),
                           build_schedule(cfg, 1, 1))
        restore_checkpoint(latest, state)
        logger.info('loaded %s', latest)
    else:
        logger.warning('no checkpoint in %s; evaluating random init', args.save_dir)
    forward = make_forward(model)

    def probs(batch):
        return torch.softmax(forward(to_device(batch, device)).float(), dim=-1)

    tta = None
    if not args.no_tta:
        # TTA protocol (the reference's tools/eval.py:97-100)
        tta = MultiScaleFlipAug(dataset, scales=[0.95, 1.0, 1.05],
                                angles=[-np.pi / 4, 0.0, np.pi / 4],
                                flip_x=True, flip_y=True,
                                dataset_factory=dataset_factory,
                                num_workers=0 if tta_device else args.tta_workers)
        if tta.num_variants() % max(args.tta_batch, 1) != 0:
            tta.close()
            raise ValueError(f'--tta_batch={args.tta_batch} must divide the variant count '
                             f'({tta.num_variants()})')

    if tta_device:
        p_cap = int(cfg.RUNTIME.MAX_POINTS_PER_SAMPLE)
        params = torch.from_numpy(variant_params(tta)).to(device)
    metric = IOUMetric(dataset.class_names)
    try:
        for i in range(len(dataset)):
            # TTA must start from the RAW cartesian sample: __getitem__'s
            # output is already cylinder-transformed and voxelized.
            raw = dataset.load_raw(i)
            if tta is None:
                prepared = dataset.prepare_data(raw)
                dataset.prepare_voxel_labels(prepared)
                b = collate_padded([dataset.pad(prepared)])
                preds = forward(to_device(b, device))[0].argmax(dim=-1).cpu().numpy()
                mask = b['point_mask'][0] & b['cur_point_mask'][0]
                gt = b['point_labels'][0]
            elif tta_device:
                # the host pads the raw cloud, cut to the point capacity;
                # every variant's transform and voxelization happen in
                # tta_device_group. Every kept point is scored, those
                # outside the range included.
                pts = np.asarray(raw['points'], np.float32)[:p_cap]
                n = pts.shape[0]
                points1 = np.zeros((p_cap, pts.shape[1]), np.float32)
                points1[:n] = pts
                mask = np.zeros(p_cap, bool)
                mask[:n] = True
                gt = np.full(p_cap, 255, np.int32)
                gt[:n] = np.asarray(raw['point_labels'], np.int32)[:n]
                points1 = torch.from_numpy(points1).to(device)
                pmask1 = torch.from_numpy(mask).to(device)
                g = max(args.tta_batch, 1)
                acc = None
                for lo in range(0, len(params), g):
                    ps = tta_device_group(model, spec, points1, pmask1, params[lo:lo + g],
                                          int(cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE))
                    acc = ps if acc is None else acc + ps
                preds = acc.argmax(dim=-1).cpu().numpy()
            else:
                # softmax sum over the variants, in padded order (the variants
                # share the raw order: eval applies no shuffles), summed on
                # the device --tta_batch variants at a time
                acc, mask, gt, group = None, None, None, []
                for b in tta(raw, index=i):
                    if mask is None:
                        mask = b['point_mask'][0] & b['cur_point_mask'][0]
                        gt = b['point_labels'][0]
                    group.append(b)
                    if len(group) < max(args.tta_batch, 1):
                        continue
                    big = {k: np.concatenate([g[k] for g in group])
                           for k in group[0] if k != 'batch_size'}
                    group = []
                    ps = probs(big).sum(dim=0)
                    acc = ps if acc is None else acc + ps
                preds = acc.argmax(dim=-1).cpu().numpy()
            metric.add(preds[mask], gt[mask])
            if (i + 1) % args.log_iter_interval == 0:
                logger.info('evaluated [%d/%d]', i + 1, len(dataset))
    finally:
        if tta is not None:
            tta.close()
    result = metric.get_metric()
    logger.info('Metrics on validation dataset: mIoU=%.4f', result['mIOU'])
    for k, v in result['IOU'].items():
        logger.info('  %s: %.4f', k, v)
    print('mIoU', result['mIOU'])
    return dict(result, hist=metric.hist)


def variant_params(tta) -> np.ndarray:
    """[36, 4] float32 rows of (scale, angle, x_mult, y_mult) over
    ``MultiScaleFlipAug._variant_params()``, in its order: flip_y negates x
    and flip_x negates y, as ``_prepare_variant`` does."""
    return np.asarray([(s, a, -1.0 if fy else 1.0, -1.0 if fx else 1.0)
                       for s, a, fx, fy in tta._variant_params()], np.float32)


def transform_variants(points1: torch.Tensor, var_params: torch.Tensor) -> torch.Tensor:
    """points1 [P, D], var_params [G, 4] -> [G, P, D]: xyz scaled, rotated
    about z (x toward y: xyz @ [[c, s, 0], [-s, c, 0], [0, 0, 1]]), then the
    sign multipliers on x and y; the other columns as they are. float32
    elementwise products and sums, the three-term row products of the
    reference's matmul without its two zero terms."""
    scale, angle, mx, my = (var_params[:, i, None] for i in range(4))
    x, y, z = (points1[None, :, i] * scale for i in range(3))
    c, s = torch.cos(angle), torch.sin(angle)
    xyz = torch.stack([(x * c - y * s) * mx, (x * s + y * c) * my, z], dim=-1)
    rest = points1[None, :, 3:].expand(var_params.shape[0], -1, -1)
    return torch.cat([xyz, rest], dim=-1)


def tta_device_group(model, spec, points1: torch.Tensor, pmask1: torch.Tensor,
                     var_params: torch.Tensor, max_voxels: int) -> torch.Tensor:
    """The device TTA of one group of variants (the JAX package's
    ``tools/eval.py:107-135``): points1 [P, D] padded raw cloud, pmask1 [P],
    var_params [G, 4] rows of (scale, angle, x_mult, y_mult) -> [P, C]
    float32, the sum over the G variants of the point softmax. The G
    variants are transformed (``transform_variants``), voxelized
    (``ops/voxelize.device_voxelize``) and run as one batch of G samples
    whose current points are every valid point."""
    from ..ops.voxelize import device_voxelize
    pts = transform_variants(points1, var_params)
    pm = pmask1[None].expand(pts.shape[0], -1)
    coords, vmask, vids, _ = device_voxelize(pts, pm, spec.voxel_size, spec.point_cloud_range,
                                             max_voxels)
    batch = {'points': pts, 'point_mask': pm, 'cur_point_mask': pm, 'point_voxel_ids': vids,
             'voxel_coords': coords, 'voxel_mask': vmask}
    model.eval()
    with torch.inference_mode():
        out = model(batch)['point_out']
    return torch.softmax(out.float(), dim=-1).sum(dim=0)


if __name__ == '__main__':
    main()

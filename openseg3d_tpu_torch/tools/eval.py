"""Offline evaluation with test-time augmentation, on one GPU (or on the CPU
with ``--device cpu``).

    python -m openseg3d_tpu_torch.tools.eval --cfg_file configs/synthetic_accuracy.yaml \
        --synthetic --save_dir runs/synth_torch [--no_tta] [--tta_batch 2 --tta_workers 4]

Counterpart of ``tools/eval.py``, with its flags plus ``--device`` (default
``cuda``): the newest ``epoch_N.pt`` of the save directory (random weights
if there is none), the validation split, and either one forward per frame
(``--no_tta``) or the 36-variant host TTA (3 scales x 3 angles x flip_x x
flip_y, ``data/test_time_aug.MultiScaleFlipAug``), ``--tta_batch`` variants
per forward, prepared by ``--tta_workers`` processes. The softmax sums stay on
the device; one argmax per frame comes back. ``--tta_device`` (variants
transformed and voxelized on the device) is not ported yet and raises
(ROADMAP A14).
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
                   help='TTA transforms and voxelization on the device (not ported yet)')
    p.add_argument('--device', default='cuda',
                   help="torch device to evaluate on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the evaluation, logging to the console and to eval.log in the
    save directory. Returns the metric ('mIOU', 'IOU') and the confusion
    histogram ('hist', rows = ground truth)."""
    args = parse_args(argv)
    if args.tta_device:
        raise NotImplementedError('--tta_device is not ported yet (ROADMAP A14)')
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
    if args.synthetic:
        from ..data.synthetic import SyntheticDataset
        dataset_factory = functools.partial(
            SyntheticDataset, cfg, args.synthetic_frames, mode='validation')
    else:
        from ..data.waymo_dataset import WaymoDataset
        dataset_factory = functools.partial(WaymoDataset, cfg, args.data_dir, 'validation')
    dataset = dataset_factory()

    model, _ = build_segmentor(cfg, device)
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
                                num_workers=args.tta_workers)
        if tta.num_variants() % max(args.tta_batch, 1) != 0:
            tta.close()
            raise ValueError(f'--tta_batch={args.tta_batch} must divide the variant count '
                             f'({tta.num_variants()})')

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


if __name__ == '__main__':
    main()

"""Train a 3D segmentor on one GPU (or on the CPU with ``--device cpu``).

    python -m openseg3d_tpu_torch.tools.train --cfg_file configs/synthetic_accuracy.yaml \
        --synthetic --save_dir runs/synth_torch --epochs 12

Counterpart of ``tools/train.py``, with its flags and its log lines, plus
``--device`` (default ``cuda``). Each step is ``engine.make_train_step``;
``epoch_N.pt`` is saved after every epoch, and ``--auto_resume`` continues
from the newest one with its update count and step count, so the schedule and
the per-step dropout generators carry on where they stopped; with
``--deterministic`` a resumed run ends where an uninterrupted one does, to
the bit on the GPU too. Validation runs
``make_eval_step(..., with_loss=True)`` every ``--eval_epoch_interval``
epochs. Flags for what is not ported yet raise ``NotImplementedError`` with
their roadmap item: more than one device or ``--launcher jax`` (A10).
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a 3d segmentor')
    p.add_argument('--cfg_file', type=str, default=None)
    p.add_argument('--data_dir', type=str, default=None)
    p.add_argument('--save_dir', type=str, required=True)
    p.add_argument('--pretrained_path', type=str, default=None)
    p.add_argument('--batch_size', default=2, type=int,
                   help='per-process batch size')
    p.add_argument('--num_workers', default=4, type=int)
    p.add_argument('--launcher', choices=['none', 'jax'], default='none')
    p.add_argument('--epochs', default=30, type=int)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--deterministic', action='store_true', default=False,
                   help='deterministic algorithms (torch.use_deterministic_algorithms, '
                        'warning where an op has none): on the GPU, the sums that still '
                        'use atomics (the index_add_ of the devoxelize gather\'s backward) '
                        'no longer vary from run to run')
    p.add_argument('--sync_bn', action='store_true', default=False,
                   help='accepted for parity; one device has one BatchNorm')
    p.add_argument('--no_validate', action='store_true')
    p.add_argument('--eval_epoch_interval', default=2, type=int)
    p.add_argument('--log_iter_interval', default=10, type=int)
    p.add_argument('--auto_resume', action='store_true')
    p.add_argument('--synthetic', action='store_true',
                   help='train on synthetic frames (no dataset required)')
    p.add_argument('--synthetic_frames', default=64, type=int)
    p.add_argument('--num_devices', default=0, type=int)
    p.add_argument('--device', default='cuda',
                   help="torch device to train on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The requested device; 'cuda' without a card raises."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on the CPU')
    return device


def evaluate(args, loader, eval_step, device, class_names, epoch, logger):
    from ..core.metrics import IOUMetric
    from ..data.batch import to_device

    metric = IOUMetric(class_names)
    losses = []
    for step_i, batch in enumerate(loader, 1):
        out = eval_step(to_device(batch, device))
        metric.add_hist(out['hist'].cpu().numpy())
        losses.append(float(out['loss']))
        if step_i % args.log_iter_interval == 0:
            logger.info('Evaluate epoch %d - Iter [%d/%d] loss: %.4f',
                        epoch, step_i, len(loader), losses[-1])
    result = metric.get_metric()
    logger.info('Metrics on validation dataset: mIoU=%.4f %s',
                result['mIOU'], result['IOU'])
    return result


def main(argv=None) -> dict:
    """Runs the training, logging to the console and to train.log in the
    save directory. Returns its history: 'train', one (epoch, iter, lr,
    loss, step ms, data-wait ms) per logged iteration; 'val', one (epoch,
    mIoU) per validation; 'skipped', the updates dropped by the
    non-finite guard."""
    args = parse_args(argv)
    if args.launcher != 'none' or args.num_devices > 1:
        raise NotImplementedError('more than one device is not ported yet (ROADMAP A10)')
    device = resolve_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    from ..utils.logging import get_root_logger, log_to_file
    previous = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with log_to_file(get_root_logger(), os.path.join(args.save_dir, 'train.log')) as logger:
            return _train(args, device, logger)
    finally:
        torch.use_deterministic_algorithms(previous[0], warn_only=previous[1])


def _train(args, device, logger) -> dict:
    from ..config import cfg_from_file
    from ..data.batch import to_device
    from ..data.loader import DataLoader
    from ..engine import TrainState, build_segmentor, make_eval_step, make_train_step
    from ..models.optim import build_optimizer, build_schedule
    from ..utils.checkpoint import (latest_checkpoint, load_pretrained, restore_checkpoint,
                                    save_checkpoint)
    from ..utils.random import init_random_seed, set_random_seed
    from ..utils.timer import Timer
    from ..weights import init_weights

    logger.info('process 0/1, device: %s', torch.cuda.get_device_name(device)
                if device.type == 'cuda' else device)

    seed = init_random_seed(args.seed)
    set_random_seed(seed)
    logger.info('seed: %d', seed)

    cfg = cfg_from_file(args.cfg_file)
    t0 = time.time()
    model, spec = build_segmentor(cfg, device)
    init_weights(model, torch.Generator().manual_seed(seed))

    # data (factories must pickle: loader workers are spawned, not forked)
    if args.synthetic:
        from ..data.synthetic import SyntheticDataset
        mk_train = functools.partial(SyntheticDataset, cfg, args.synthetic_frames,
                                     mode='training', seed=seed)
        mk_val = functools.partial(SyntheticDataset, cfg,
                                   max(args.synthetic_frames // 4, 2),
                                   mode='validation', seed=seed + 777)
    else:
        from ..data.waymo_dataset import WaymoDataset
        mk_train = functools.partial(WaymoDataset, cfg, args.data_dir, 'training')
        mk_val = functools.partial(WaymoDataset, cfg, args.data_dir, 'validation')

    train_loader = DataLoader(mk_train, args.batch_size, shuffle=True,
                              num_workers=args.num_workers, seed=seed)
    val_loader = DataLoader(mk_val, args.batch_size, shuffle=False,
                            num_workers=0, drop_last=False)
    dataset = train_loader.dataset
    iters_per_epoch = len(train_loader)
    logger.info('dataset: %d frames, %d iters/epoch', len(dataset), iters_per_epoch)

    # optimizer + schedule (per-iteration stepping)
    schedule = build_schedule(cfg, args.epochs, iters_per_epoch)
    state = TrainState(model, build_optimizer(cfg, model.parameters()), schedule)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info('model: %s, %.1fM params (init %.0fs)',
                cfg.MODEL.SEGMENTOR, n_params / 1e6, time.time() - t0)

    start_epoch = 0
    if args.pretrained_path:
        load_pretrained(args.pretrained_path, model, logger)
    if args.auto_resume:
        latest = latest_checkpoint(args.save_dir)
        if latest:
            state, start_epoch = restore_checkpoint(latest, state)
            logger.info('resumed from %s at epoch %d', latest, start_epoch)

    train_step = make_train_step(cfg, spec)
    eval_step = make_eval_step(cfg, spec, model, with_loss=True)
    history = {'train': [], 'val': [], 'skipped': 0}

    try:
        for epoch in range(start_epoch, args.epochs):
            cur_epoch = epoch + 1
            train_loader.set_epoch(epoch)
            t_epoch = time.time()
            data_timer, step_timer = Timer(), Timer()
            it = iter(train_loader)
            step_i = 0
            n_skipped = 0    # every iteration's flag counts, not only logged ones
            while True:
                with data_timer:
                    batch = next(it, None)
                if batch is None:
                    break
                step_i += 1
                with step_timer:
                    state, metrics = train_step(state, to_device(batch, device), seed)
                    n_skipped += not metrics['grads_finite']
                    if device.type == 'cuda':
                        torch.cuda.synchronize(device)   # the step's time, not its launch
                if step_i % args.log_iter_interval == 0:
                    loss = float(metrics['loss'])
                    if n_skipped:
                        # skip-and-log policy (engine.make_train_step): the
                        # updates were dropped; surface them loudly
                        logger.error(
                            'NON-FINITE GRADIENTS: %d update(s) skipped in '
                            'the last %d iters (epoch %d, through iter %d, '
                            'loss=%f)', n_skipped, args.log_iter_interval,
                            cur_epoch, step_i, loss)
                        history['skipped'] += n_skipped
                        n_skipped = 0
                    lr = float(schedule(state.updates))
                    logger.info('Train - Epoch [%d/%d] Iter [%d/%d] lr: %f, loss: %f, '
                                'step: %.0fms, data-wait: %.0fms',
                                cur_epoch, args.epochs, step_i, iters_per_epoch, lr, loss,
                                step_timer.mean * 1e3, data_timer.mean * 1e3)
                    history['train'].append((cur_epoch, step_i, lr, loss,
                                             step_timer.mean * 1e3, data_timer.mean * 1e3))
                    data_timer.reset()
                    step_timer.reset()
            if n_skipped:   # trailing iterations after the last log step
                logger.error('NON-FINITE GRADIENTS: %d update(s) skipped in the '
                             'trailing iters of epoch %d', n_skipped, cur_epoch)
                history['skipped'] += n_skipped
            logger.info('epoch %d done in %.1fs', cur_epoch, time.time() - t_epoch)

            save_checkpoint(args.save_dir, cur_epoch, state, logger)
            if not args.no_validate and cur_epoch % args.eval_epoch_interval == 0:
                result = evaluate(args, val_loader, eval_step, device,
                                  dataset.class_names, cur_epoch, logger)
                history['val'].append((cur_epoch, result['mIOU']))
    finally:
        train_loader.close()
        val_loader.close()
    logger.info('training complete')
    return history


if __name__ == '__main__':
    main()

"""Leaderboard inference: the testing split -> a Waymo eval-server submission,
on one GPU (or on the CPU with ``--device cpu``).

    python -m openseg3d_tpu_torch.tools.test --cfg_file configs/waymo_one_sweep.yaml \
        --data_dir data/waymo --save_dir runs/waymo_torch

Counterpart of ``tools/test.py``, with its flags plus ``--device`` (default
``cuda``): the newest checkpoint of the save directory (``epoch_N.pt``, or a
JAX run's ``epoch_N/``: ``utils/checkpoint.load_model``), every frame of
the testing frame list through ``engine.make_forward`` one at a time, the
argmax over the frame's current points (``point_mask & cur_point_mask``: a
multi-sweep frame's history points are never submitted) scattered into the
two-return range image through ``points_ri``, and
``wod_test_set_pred_semantic_seg.bin`` in the save directory. Without
``waymo_open_dataset`` and with ``OPENSEG3D_ALLOW_WOD_STUB=1`` the
pickle-backed stand-in of ``utils/wod_stub`` writes the file instead (not a
valid upload; ``wod_stub.read_submission`` decodes it).
"""

from __future__ import annotations

import argparse
import os

from .train import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Run leaderboard inference')
    p.add_argument('--cfg_file', type=str, default=None)
    p.add_argument('--data_dir', type=str, required=True)
    p.add_argument('--save_dir', type=str, required=True)
    p.add_argument('--account', type=str, default='')
    p.add_argument('--method_name', type=str, default='openseg3d_tpu_torch')
    p.add_argument('--log_iter_interval', default=10, type=int)
    p.add_argument('--device', default='cuda',
                   help="torch device to run on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Writes the submission, logging to the console and to test.log in the
    save directory. Returns the submission file's path."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    from ..utils.logging import get_root_logger, log_to_file
    with log_to_file(get_root_logger(), os.path.join(args.save_dir, 'test.log')) as logger:
        if os.environ.get('OPENSEG3D_ALLOW_WOD_STUB') == '1':
            try:
                import waymo_open_dataset  # noqa: F401
            except ImportError:
                from ..utils.wod_stub import install
                install()
                logger.warning('waymo_open_dataset stub installed: the submission file '
                               'is a rehearsal artifact, not a valid proto upload')
        return _test(args, device, logger)


def _test(args, device, logger) -> str:
    from ..config import cfg_from_file
    from ..data.batch import collate_padded, to_device
    from ..data.waymo_dataset import WaymoDataset
    from ..engine import build_segmentor, make_forward
    from ..utils.checkpoint import latest_checkpoint, load_model
    from ..utils.submission import construct_seg_frame, write_submission_file

    cfg = cfg_from_file(args.cfg_file)
    dataset = WaymoDataset(cfg, args.data_dir, 'testing')
    logger.info('testing frames: %d', len(dataset))
    latest = latest_checkpoint(args.save_dir)
    if latest is None:
        raise FileNotFoundError(f'no checkpoint found in {args.save_dir}')
    model, _ = build_segmentor(cfg, device)
    load_model(latest, model)
    logger.info('loaded %s', latest)
    forward = make_forward(model)

    frames = []
    for i in range(len(dataset)):
        raw = dataset[i]
        file_idx, _, ts = dataset.parse_filename(raw['filename'])
        b = collate_padded([dataset.pad(raw)])
        preds = forward(to_device(b, device))[0].argmax(dim=-1).cpu().numpy()
        mask = b['point_mask'][0] & b['cur_point_mask'][0]
        frames.append(construct_seg_frame(preds[mask], b['points_ri'][0][mask],
                                          context_name=file_idx, timestamp=ts))
        if (i + 1) % args.log_iter_interval == 0:
            logger.info('inferred [%d/%d]', i + 1, len(dataset))
    path = write_submission_file(frames, args.save_dir, account=args.account,
                                 method_name=args.method_name)
    logger.info('submission written to %s', path)
    return path


if __name__ == '__main__':
    main()

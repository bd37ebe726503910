"""Real-schema rehearsal at production capacities: train -> eval -> test ->
submission, each tool in its own process.

    python -m openseg3d_tpu_torch.tools.rehearsal --work_dir runs/rehearsal_torch [--frames 6]

Counterpart of ``tools/rehearsal.py``, with its flags and defaults plus
``--device`` (default ``cuda``); the default work directory is the port's
own, so that the two packages' checkpoints never share a save directory.
It writes ``--frames`` frames of the benchmark cloud in the offline parser's
on-disk format (``data/synthetic.make_tree``: 15-column lidar .npy with the
range-image index as the parser writes it, [N, 2] labels, 4x4 poses, an
instance bank, the test-set frame list) under ``<work_dir>/data``, then
drives the Waymo reader through the three command-line tools with
``<work_dir>/ckpt`` as their save directory:

  * ``python -m openseg3d_tpu_torch.tools.train`` (batch 1, 2 loader
    workers, seed 0, every step logged, no validation);
  * ``python -m openseg3d_tpu_torch.tools.eval --no_tta``;
  * ``python -m openseg3d_tpu_torch.tools.test`` with
    ``OPENSEG3D_ALLOW_WOD_STUB=1`` (the stand-in protos of ``utils/wod_stub``
    where ``waymo_open_dataset`` is missing).

Their output goes to ``<work_dir>/rehearsal.log``. ``--lr``, ``--optimizer``
and ``--drop_path`` override the config through a derived file in the work
directory. ``main(argv)`` returns the logged losses, the eval mIoU and the
submission's path and size, and prints the original's summary lines.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='train -> eval -> test -> submission on '
                                             'generated frames in the parser\'s format')
    ap.add_argument('--work_dir', default='runs/rehearsal_torch')
    ap.add_argument('--frames', type=int, default=6)
    ap.add_argument('--n_points', type=int, default=163840)
    ap.add_argument('--cfg_file', default='configs/waymo_one_sweep.yaml')
    ap.add_argument('--epochs', type=int, default=1)
    ap.add_argument('--lr', type=float, default=None,
                    help='override TRAIN.LR via a derived config (the shipped SGD lr=0.05 '
                         'is tuned for 30-epoch runs; a short rehearsal needs a smaller one '
                         'to show learning, not just plumbing)')
    ap.add_argument('--optimizer', default=None,
                    help='override TRAIN.OPTIMIZER (short schedules converge with adamw)')
    ap.add_argument('--drop_path', type=float, default=None,
                    help='override MODEL.DROP_PATH_RATE (0.3 regularizes 30-epoch runs but '
                         'stalls short schedules)')
    ap.add_argument('--device', default='cuda',
                    help="torch device of the three tools: 'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def run(cmd, log):
    """Run one tool from the repository root, its output appended to `log`;
    raises SystemExit with the log's tail when it fails."""
    print('>>', ' '.join(cmd), flush=True)
    env = dict(os.environ, OPENSEG3D_ALLOW_WOD_STUB='1',
               PYTHONPATH=os.pathsep.join(filter(None, (REPO, os.environ.get('PYTHONPATH')))))
    with open(log, 'ab') as fh:
        fh.write((' '.join(cmd) + '\n').encode())
        fh.flush()
        p = subprocess.run(cmd, cwd=REPO, stdout=fh, stderr=subprocess.STDOUT, env=env)
    if p.returncode != 0:
        with open(log, errors='replace') as fh:
            print(fh.read()[-3000:])
        raise SystemExit(f'FAILED rc={p.returncode}: {" ".join(cmd)}')


def derived_config(args, work: str) -> str:
    """The config file to run: --cfg_file, or a copy with the overrides."""
    cfg_file = os.path.join(REPO, args.cfg_file)
    if args.lr is None and args.optimizer is None and args.drop_path is None:
        return cfg_file
    import yaml
    with open(cfg_file) as fh:
        ycfg = yaml.safe_load(fh) or {}
    if args.lr is not None:
        ycfg.setdefault('TRAIN', {})['LR'] = args.lr
    if args.optimizer is not None:
        ycfg.setdefault('TRAIN', {})['OPTIMIZER'] = args.optimizer
    if args.drop_path is not None:
        ycfg.setdefault('MODEL', {})['DROP_PATH_RATE'] = args.drop_path
    out = os.path.join(work, 'cfg_rehearsal.yaml')
    with open(out, 'w') as fh:
        yaml.safe_dump(ycfg, fh)
    return out


def main(argv=None) -> dict:
    """Returns {'losses': the train step losses as logged, 'miou': the eval
    mIoU, 'submission': its path, 'size': its bytes, 'names': the frame
    names, 'data_dir', 'save_dir', 'cfg_file'}."""
    args = parse_args(argv)
    from ..data.synthetic import make_tree

    work = os.path.join(REPO, args.work_dir)
    data = os.path.join(work, 'data')
    save = os.path.join(work, 'ckpt')
    os.makedirs(save, exist_ok=True)
    log = os.path.join(work, 'rehearsal.log')
    names = make_tree(data, args.frames, args.n_points)
    print(f'fixture tree: {args.frames} frames x {args.n_points} pts', flush=True)
    cfg_file = derived_config(args, work)

    py = [sys.executable, '-m']
    common = ['--cfg_file', cfg_file, '--data_dir', data, '--save_dir', save,
              '--device', args.device]
    run(py + ['openseg3d_tpu_torch.tools.train', *common, '--epochs', str(args.epochs),
              '--batch_size', '1', '--num_workers', '2', '--seed', '0',
              '--log_iter_interval', '1', '--no_validate'], log)
    run(py + ['openseg3d_tpu_torch.tools.eval', *common, '--no_tta'], log)
    run(py + ['openseg3d_tpu_torch.tools.test', *common,
              '--account', 'rehearsal@example.com', '--method_name', 'rehearsal'], log)

    subs = sorted(f for f in os.listdir(save) if 'submission' in f or f.endswith('.bin'))
    if not subs:
        raise RuntimeError(f'no submission file in {save}')
    path = os.path.join(save, subs[0])
    size = os.path.getsize(path)
    if size <= 1000:
        raise RuntimeError(f'submission file suspiciously small ({size}B)')

    with open(log, errors='replace') as fh:
        text = fh.read()
    losses = [float(m) for m in re.findall(r'Train - Epoch .* loss: ([-+0-9.eEnaif]+),', text)]
    mious = [float(m) for m in re.findall(r'^mIoU ([-+0-9.eEnaif]+)$', text, re.M)]
    if losses:
        print(f'train loss: first={losses[0]:.2f} last={losses[-1]:.2f} '
              f'({len(losses)} logged steps)', flush=True)
    if mious:
        print(f'eval mIoU: {mious[-1]}', flush=True)
    print(f'REHEARSAL OK: train+eval+test+submission at production caps '
          f'({args.frames} frames x {args.epochs} epochs, {args.n_points} pts/frame); '
          f'submission {subs[0]} = {size} bytes', flush=True)
    return {'losses': losses, 'miou': mious[-1] if mious else None, 'submission': path,
            'size': size, 'names': names, 'data_dir': data, 'save_dir': save,
            'cfg_file': cfg_file}


if __name__ == '__main__':
    main()

"""Convert a JAX run's orbax checkpoint into an ``epoch_N.pt`` of this package.

    python -m openseg3d_tpu_torch.tools.import_checkpoint runs/exp1/epoch_12 runs/exp1_torch \
        [--cfg_file configs/waymo_one_sweep.yaml]

Reads ``SRC`` (an ``epoch_N/`` directory that the JAX package's
``save_checkpoint`` wrote) with tensorstore, maps it onto the port's
``TrainState`` for the config (``utils/checkpoint.import_jax_checkpoint``:
parameters, BatchNorm statistics, the SGD or AdamW state, the step and update
counts) on the CPU, and writes ``DST/epoch_N.pt``, from which ``tools.train
--auto_resume``, ``tools.eval`` and ``tools.test`` continue on a host without
tensorstore (the GPU machine). ``main(argv)`` returns the written path.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Convert a JAX (orbax) checkpoint to epoch_N.pt')
    p.add_argument('src', help="the JAX run's epoch_N/ directory")
    p.add_argument('dst', help='the save directory to write epoch_N.pt into')
    p.add_argument('--cfg_file', type=str, default=None,
                   help='the config the JAX run trained (its model and optimizer)')
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    from ..config import cfg_from_file
    from ..engine import TrainState, build_segmentor
    from ..models.optim import build_optimizer, build_schedule
    from ..utils.checkpoint import import_jax_checkpoint, is_orbax_checkpoint, save_checkpoint
    from ..utils.logging import get_root_logger
    if not is_orbax_checkpoint(args.src):
        raise FileNotFoundError(f'{args.src} is not a complete orbax checkpoint '
                                '(no manifest.ocdbt)')
    cfg = cfg_from_file(args.cfg_file)
    model, _ = build_segmentor(cfg, device='cpu')
    state = TrainState(model, build_optimizer(cfg, model.parameters()),
                       build_schedule(cfg, 1, 1))
    epoch = import_jax_checkpoint(args.src, state)
    os.makedirs(args.dst, exist_ok=True)
    save_checkpoint(args.dst, epoch, state, get_root_logger())
    path = os.path.join(args.dst, f'epoch_{epoch}.pt')
    print(f'{args.src} -> {path} (epoch {epoch}, step {state.step}, updates {state.updates})')
    return path


if __name__ == '__main__':
    main()

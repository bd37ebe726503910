"""Checkpoint save and resume with ``torch.save``.

Counterpart of ``openseg3d_tpu/utils/checkpoint.py`` (orbax there): one file
``epoch_N.pt`` per epoch under the save directory, holding the model's
state_dict (parameters and BatchNorm statistics), the optimizer's state_dict,
``TrainState.step`` and ``.updates`` (the schedule's input) and the epoch.
A save writes a temporary file and renames it into place, so a save that was
cut off never looks complete (the original's ``_is_complete``). Files are
read with ``weights_only=True``: tensors and plain containers, no arbitrary
objects.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r'^epoch_(\d+)\.pt$')


def save_checkpoint(save_dir: str, epoch: int, state, logger=None) -> None:
    """Write ``epoch_{epoch}.pt``."""
    if logger:
        logger.info('Save checkpoint at epoch %d', epoch)
    path = os.path.join(save_dir, f'epoch_{epoch}.pt')
    payload = {'model': state.model.state_dict(),
               'optimizer': state.optimizer.state_dict(),
               'step': state.step, 'updates': state.updates, 'epoch': epoch}
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)


def latest_checkpoint(save_dir: str) -> str | None:
    """The complete ``epoch_N.pt`` with the highest N, or None."""
    best, best_e = None, -1
    if os.path.isdir(save_dir):
        for name in os.listdir(save_dir):
            m = _NAME.match(name)
            if m and int(m.group(1)) > best_e:
                best, best_e = os.path.join(save_dir, name), int(m.group(1))
    return best


def restore_checkpoint(path: str, state):
    """Load a full training state in place; returns (state, epoch)."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload['model'])
    state.optimizer.load_state_dict(payload['optimizer'])
    state.step, state.updates = int(payload['step']), int(payload['updates'])
    return state, int(payload['epoch'])


def load_pretrained(path: str, model: torch.nn.Module, logger=None) -> torch.nn.Module:
    """Non-strict load of the parameters whose name and shape match (a
    checkpoint of this module or a bare state_dict); the other parameters and
    the BatchNorm statistics keep their values, as in the original."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    src = payload.get('model', payload)
    params = dict(model.named_parameters())
    matched = {k: v for k, v in src.items()
               if k in params and tuple(v.shape) == tuple(params[k].shape)}
    with torch.no_grad():
        for k, v in matched.items():
            params[k].copy_(v)
    if logger and len(matched) < len(params):
        logger.info('pretrained load skipped %d/%d leaves', len(params) - len(matched),
                    len(params))
    return model

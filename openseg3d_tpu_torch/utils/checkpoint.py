"""Checkpoint save and resume with ``torch.save``, and the import of the JAX
package's orbax checkpoints.

Counterpart of ``openseg3d_tpu/utils/checkpoint.py`` (orbax there): one file
``epoch_N.pt`` per epoch under the save directory, holding the model's
state_dict (parameters and BatchNorm statistics), the optimizer's state_dict,
``TrainState.step`` and ``.updates`` (the schedule's input) and the epoch.
A save writes a temporary file and renames it into place, so a save that was
cut off never looks complete (the original's ``_is_complete``). Files are
read with ``weights_only=True``: tensors and plain containers, no arbitrary
objects. With more than one rank, rank 0 writes and every rank waits at a
barrier; each rank restores onto its own model's device.

A JAX run's save directory holds ``epoch_N/`` directories in orbax's OCDBT
format instead (complete once ``manifest.ocdbt`` is written).
``restore_checkpoint``, ``latest_checkpoint``, ``load_pretrained`` and
``load_model`` take them wherever they take an ``epoch_N.pt``, so that
``--auto_resume``, ``--pretrained_path`` and the eval and test tools run over
a JAX run's directory. ``read_orbax_checkpoint`` reads the leaves with
``tensorstore`` alone (imported when called: no JAX, flax or orbax), and
``import_jax_checkpoint`` maps them onto the port's state: ``params`` and
``batch_stats`` by their flax names (``weights.load_flax_variables``); optax
SGD's momentum ``trace`` to SGD's ``momentum_buffer``; AdamW's ``mu``,
``nu`` and ``count`` to ``exp_avg``, ``exp_avg_sq`` and ``step``; ``step``
and optax's update count to ``TrainState.step`` and ``.updates``. A host
without tensorstore converts through ``python -m
openseg3d_tpu_torch.tools.import_checkpoint`` on a host with it.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from ..parallel.dist import barrier, rank

_NAME = re.compile(r'^epoch_(\d+)(\.pt)?$')


def save_checkpoint(save_dir: str, epoch: int, state, logger=None) -> None:
    """Write ``epoch_{epoch}.pt`` (rank 0), then wait for it on every rank."""
    if rank() == 0:
        if logger:
            logger.info('Save checkpoint at epoch %d', epoch)
        path = os.path.join(save_dir, f'epoch_{epoch}.pt')
        payload = {'model': state.model.state_dict(),
                   'optimizer': state.optimizer.state_dict(),
                   'step': state.step, 'updates': state.updates, 'epoch': epoch}
        tmp = f'{path}.{os.getpid()}.tmp'
        torch.save(payload, tmp)
        os.replace(tmp, path)
    barrier()


def is_orbax_checkpoint(path: str) -> bool:
    """A complete orbax checkpoint directory of the JAX package."""
    return os.path.isfile(os.path.join(path, 'manifest.ocdbt'))


def latest_checkpoint(save_dir: str) -> str | None:
    """The complete checkpoint with the highest epoch: an ``epoch_N.pt`` or
    a JAX run's ``epoch_N/`` orbax directory; the ``.pt`` where both hold
    the same epoch. None if there is none."""
    best, best_key = None, None
    if os.path.isdir(save_dir):
        for name in os.listdir(save_dir):
            m = _NAME.match(name)
            path = os.path.join(save_dir, name)
            if not m or not (m.group(2) or is_orbax_checkpoint(path)):
                continue
            key = (int(m.group(1)), bool(m.group(2)))
            if best_key is None or key > best_key:
                best, best_key = path, key
    return best


def read_orbax_checkpoint(path: str) -> dict:
    """{dotted leaf path: numpy array} of an orbax checkpoint directory
    (``params.Dense_0.kernel``, ``opt_state.1.0.trace....``, ``step``,
    ``epoch``), read with tensorstore. Raises ImportError naming the
    conversion route where tensorstore is missing."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f'reading the orbax checkpoint {path} needs tensorstore, which this host lacks: '
            f'convert it where tensorstore is installed with `python -m '
            f'openseg3d_tpu_torch.tools.import_checkpoint {path} DST_DIR`, which writes '
            f'DST_DIR/epoch_N.pt for this package') from e
    path = os.path.abspath(path)
    with open(os.path.join(path, '_METADATA')) as fh:
        meta = json.load(fh)
    driver = 'zarr3' if meta.get('use_zarr3') else 'zarr'
    context = ts.Context()
    names = ['.'.join(str(k['key']) for k in leaf['key_metadata'])
             for leaf in meta['tree_metadata'].values()
             if not leaf['value_metadata'].get('skip_deserialize')]  # skip: optax's EmptyState
    # every open, then every read, issued before the first is waited for
    opened = [ts.open({'driver': driver,
                       'kvstore': {'driver': 'ocdbt', 'base': f'file://{path}', 'path': name}},
                      open=True, context=context) for name in names]
    reads = [store.result().read() for store in opened]
    return {name: np.asarray(r.result()) for name, r in zip(names, reads)}


def _tree(flat: dict, prefix: str) -> dict:
    """The nested dict of the leaves under `prefix.`."""
    tree: dict = {}
    for name, value in flat.items():
        if name.startswith(prefix + '.'):
            *keys, last = name[len(prefix) + 1:].split('.')
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = value
    return tree


def _optimizer_leaves(flat: dict) -> tuple[dict, list]:
    """({moment name: {flax path: array}} for optax's 'trace', 'mu' and
    'nu' subtrees, [every 'count']) of the opt_state leaves: found by name,
    so that the chain's positions, which vary with the optax version, do
    not matter."""
    moments: dict = {}
    counts = []
    for name, value in flat.items():
        parts = name.split('.')
        if parts[0] != 'opt_state':
            continue
        if parts[-1] == 'count':
            counts.append(int(np.asarray(value).reshape(-1)[0]))
            continue
        hit = [i for i, p in enumerate(parts) if p in ('trace', 'mu', 'nu')]
        if not hit:
            raise ValueError(f'unknown optimizer leaf {name}')
        moments.setdefault(parts[hit[0]], {})[tuple(parts[hit[0] + 1:])] = value
    return moments, counts


def import_jax_checkpoint(path: str, state) -> int:
    """Load the JAX package's orbax checkpoint `path` into `state` (a
    TrainState) in place: parameters, BatchNorm statistics, the optimizer's
    state, ``step`` and ``updates``. Returns the checkpoint's epoch."""
    from ..weights import load_flax_variables, parameter_leaves
    flat = read_orbax_checkpoint(path)
    model, optimizer = state.model, state.optimizer
    load_flax_variables(model, _tree(flat, 'params'), _tree(flat, 'batch_stats'))
    moments, counts = _optimizer_leaves(flat)
    if len(set(counts)) > 1:
        raise ValueError(f'optax counts disagree: {counts}')
    updates = counts[0] if counts else int(flat['step'].reshape(-1)[0])
    if isinstance(optimizer, torch.optim.SGD):
        names = {'trace': 'momentum_buffer'}
    elif isinstance(optimizer, torch.optim.AdamW):
        names = {'mu': 'exp_avg', 'nu': 'exp_avg_sq'}
    else:
        raise NotImplementedError(type(optimizer).__name__)
    if set(moments) != set(names):
        raise ValueError(f'{type(optimizer).__name__} state from optax moments '
                         f'{sorted(moments)}, expected {sorted(names)}')
    optimizer.state.clear()
    for path_, param, fn in parameter_leaves(model):
        slot = optimizer.state[param]
        for moment, key in names.items():
            value = np.array(fn(moments[moment][path_]), dtype=np.float32, order='C')
            if value.shape != tuple(param.shape):
                raise ValueError(f'{moment} {"/".join(path_)}: {value.shape} vs '
                                 f'{tuple(param.shape)}')
            slot[key] = torch.from_numpy(value).to(param.device)
        if isinstance(optimizer, torch.optim.AdamW):
            slot['step'] = torch.tensor(float(updates))
    state.step = int(flat['step'].reshape(-1)[0])
    state.updates = updates
    return int(flat['epoch'].reshape(-1)[0])


def restore_checkpoint(path: str, state):
    """Load a full training state in place from an ``epoch_N.pt`` or a JAX
    run's orbax directory; returns (state, epoch)."""
    if is_orbax_checkpoint(path):
        return state, import_jax_checkpoint(path, state)
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload['model'])
    state.optimizer.load_state_dict(payload['optimizer'])
    state.step, state.updates = int(payload['step']), int(payload['updates'])
    return state, int(payload['epoch'])


def load_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """The weights of a checkpoint (``epoch_N.pt`` or orbax directory) into
    `model`, strictly: every parameter and BatchNorm statistic."""
    if is_orbax_checkpoint(path):
        from ..weights import load_flax_variables
        flat = read_orbax_checkpoint(path)
        load_flax_variables(model, _tree(flat, 'params'), _tree(flat, 'batch_stats'))
        return model
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device, weights_only=True)['model'])
    return model


def load_pretrained(path: str, model: torch.nn.Module, logger=None) -> torch.nn.Module:
    """Non-strict load of the parameters whose name and shape match (a
    checkpoint of this module or a bare state_dict, or a JAX run's orbax
    directory, matched by flax path); the other parameters and the
    BatchNorm statistics keep their values, as in the original."""
    params = dict(model.named_parameters())
    if is_orbax_checkpoint(path):
        from ..weights import parameter_leaves
        src = {tuple(k.split('.')): v for k, v in read_orbax_checkpoint(path).items()}
        by_id = {id(t): n for n, t in params.items()}
        matched = {}
        for flax_path, t, fn in parameter_leaves(model):
            v = src.get(('params',) + flax_path)
            if v is not None:
                v = np.asarray(fn(v), np.float32)
                if v.shape == tuple(t.shape):
                    matched[by_id[id(t)]] = torch.from_numpy(np.ascontiguousarray(v))
    else:
        payload = torch.load(path, map_location='cpu', weights_only=True)
        src = payload.get('model', payload)
        matched = {k: v for k, v in src.items()
                   if k in params and tuple(v.shape) == tuple(params[k].shape)}
    with torch.no_grad():
        for k, v in matched.items():
            params[k].copy_(v)
    if logger and len(matched) < len(params):
        logger.info('pretrained load skipped %d/%d leaves', len(params) - len(matched),
                    len(params))
    return model

"""Rank processes for tests/test_torch_dist.py.

``run(task, world, directory, payload)`` spawns `world` processes that join
one gloo process group on the CPU (a ``file://`` rendezvous in `directory`,
so that concurrent test runs never share a port), runs ``task(rank,
payload)`` on each and returns their results in rank order. A rank that
raises fails the call with its traceback, and the others are killed; every
process is joined within `timeout` seconds. This module imports torch and
the port only: each rank starts without JAX.
"""

from __future__ import annotations

import functools
import hashlib
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch


def run(task, world: int, directory, payload, timeout: float = 300.0, threads: int = 2):
    return start(task, world, directory, payload, threads)(timeout)


def start(task, world: int, directory, payload, threads: int = 2):
    """Start the ranks; returns wait(timeout), which joins them and returns
    their results (so that the caller can work while they run)."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, 'payload.pkl'), 'wb') as f:
        pickle.dump(payload, f)
    init = 'file://' + os.path.join(directory, 'rendezvous')
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=_entry, args=(task.__name__, r, world, init, directory,
                                              threads))
             for r in range(world)]
    for p in procs:
        p.start()
    return functools.partial(_wait, procs, directory, world)


def _wait(procs, directory, world, timeout: float = 300.0):
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(directory, f'rank{r}.err')
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f'rank {r}:\n{f.read()}')
        elif p.exitcode != 0:
            errors.append(f'rank {r}: exit code {p.exitcode} (timeout {timeout} s)')
    assert not errors, '\n'.join(errors)
    out = []
    for r in range(world):
        with open(os.path.join(directory, f'rank{r}.pkl'), 'rb') as f:
            out.append(pickle.load(f))
    return out


def _entry(name, rank, world, init, directory, threads):
    torch.set_num_threads(threads)
    from openseg3d_tpu_torch.parallel import dist as pdist
    pdist.init_distributed('cpu', backend='gloo', init_method=init, rank=rank,
                           world_size=world)
    try:
        with open(os.path.join(directory, 'payload.pkl'), 'rb') as f:
            payload = pickle.load(f)
        result = globals()[name](rank, payload)
        with open(os.path.join(directory, f'rank{rank}.pkl'), 'wb') as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(directory, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        pdist.destroy()


def no_dropout(model):
    """Every dropout rate of the model at 0 (the JAX side patches flax's
    Dropout to the identity)."""
    from openseg3d_tpu_torch.models.deep_fusion import DeepFusionBlock
    from openseg3d_tpu_torch.models.ocr import OCRLayer
    from openseg3d_tpu_torch.models.segmentors.common import SegmentorHead
    from openseg3d_tpu_torch.models.swformer import MLP, WindowAttention
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.attn_drop = 0.0
        elif isinstance(m, (MLP, SegmentorHead, OCRLayer)):
            m.drop = 0.0
        elif isinstance(m, DeepFusionBlock):
            m.attn_pdrop = 0.0


def train_step(rank, p):
    """One train step on this rank's sample of p['batch'] (slot `rank` of the
    global batch) from the weights p['variables']: the port's data-parallel
    step ('global'), then the reference recipe's ('per_rank_mean': each
    rank's loss on its own rows, gradients averaged over the ranks)."""
    from openseg3d_tpu_torch import engine
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.data.batch import to_device
    from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
    from openseg3d_tpu_torch.parallel import dist as pdist
    from openseg3d_tpu_torch.weights import load_flax_variables, to_flax_variables

    cfg = cfg_from_file(None, overrides=p['overrides'])
    batch = to_device({k: v[rank:rank + 1] for k, v in p['batch'].items()
                       if k != 'batch_size'}, 'cpu')
    transfer, gather, reduce_ = (engine.nearest_label_transfer, engine.gather_rows,
                                 engine.reduce_gradients)
    aux = {}

    def recording_transfer(*args, **kwargs):
        aux['labels'] = transfer(*args, **kwargs)
        return aux['labels']

    def mean_gradients(params):
        reduce_(params)
        for q in params:
            if q.grad is not None:
                q.grad /= pdist.world()

    out = {}
    for mode in ('global', 'per_rank_mean'):
        engine.nearest_label_transfer = recording_transfer
        if mode == 'per_rank_mean':
            engine.gather_rows = lambda x: x
            engine.reduce_gradients = mean_gradients
        try:
            model, spec = engine.build_segmentor(cfg, device='cpu')
            load_flax_variables(model, *p['variables'])
            no_dropout(model)
            state = engine.TrainState(model, build_optimizer(cfg, model.parameters()),
                                      build_schedule(cfg, *p['schedule']))
            state, metrics = engine.make_train_step(cfg, spec)(state, batch, seed=0)
        finally:
            engine.nearest_label_transfer, engine.gather_rows, engine.reduce_gradients = \
                transfer, gather, reduce_
        grads, _ = to_flax_variables(model, grads=True)
        params, stats = to_flax_variables(model)
        out[mode] = {'loss': float(metrics['loss']), 'finite': metrics['grads_finite'],
                     'counts': (state.step, state.updates), 'grads': grads,
                     'params': params, 'stats': stats, 'aux': aux['labels'].numpy()}
    return out


def batch_norm(rank, p):
    """MaskedBatchNorm in training on this rank's rows (masked and
    unmasked): output, input and parameter gradients, running statistics."""
    from openseg3d_tpu_torch.models.norm import MaskedBatchNorm
    out = {}
    for masked in (True, False):
        bn = MaskedBatchNorm(p['x'][rank].shape[-1], eps=1e-3, momentum=0.9).train()
        with torch.no_grad():
            bn.scale.copy_(torch.from_numpy(p['scale']))
            bn.bias.copy_(torch.from_numpy(p['bias']))
        x = torch.from_numpy(p['x'][rank]).requires_grad_()
        mask = torch.from_numpy(p['mask'][rank]) if masked else None
        y = bn(x, mask)
        (y * torch.from_numpy(p['cotangent'][rank])).sum().backward()
        out[masked] = {'y': y.detach().numpy(), 'dx': x.grad.numpy(),
                       'dscale': bn.scale.grad.numpy(), 'dbias': bn.bias.grad.numpy(),
                       'mean': bn.mean.numpy(), 'var': bn.var.numpy()}
    return out


def eval_histogram(rank, p):
    """The eval step with the loss on this rank's shard of p['samples'] at
    p['batch'] a rank (sample_valid marks the padding duplicates), and the
    IoU metric of this rank's own valid points through IOUMetric's
    all-reduce."""
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.core.metrics import IOUMetric
    from openseg3d_tpu_torch.data.batch import collate_padded, to_device
    from openseg3d_tpu_torch.data.loader import process_shard_indices
    from openseg3d_tpu_torch.engine import build_segmentor, make_eval_step
    from openseg3d_tpu_torch.parallel import dist as pdist
    from openseg3d_tpu_torch.weights import init_weights

    cfg = cfg_from_file(None, overrides=p['overrides'])
    model, spec = build_segmentor(cfg, device='cpu')
    init_weights(model, torch.Generator().manual_seed(p['seed']))
    idx, valid = process_shard_indices(len(p['samples']), None, 0,
                                       p['batch'] * pdist.world(), return_valid=True)
    batch = collate_padded([p['samples'][i] for i in idx])
    batch['sample_valid'] = valid
    res = make_eval_step(cfg, spec, model, with_loss=True)(to_device(batch, 'cpu'))
    keep = (batch['cur_point_mask'] & batch['point_mask'] & valid[:, None])
    metric = IOUMetric(cfg.DATASET.CLASS_NAMES)
    metric.add(res['point_out'].argmax(-1).numpy()[keep], batch['point_labels'][keep])
    return {'idx': idx, 'valid': valid, 'hist': res['hist'].numpy(),
            'loss': float(res['loss']), 'miou': metric.get_metric()['mIOU']}


def train_cli(rank, p):
    """tools.train's main(p['argv']) on this rank: its history, and a digest
    of the model's tensors when each checkpoint is saved."""
    from openseg3d_tpu_torch.tools import train
    from openseg3d_tpu_torch.utils import checkpoint
    save = checkpoint.save_checkpoint
    digests = []

    def recording_save(save_dir, epoch, state, logger=None):
        h = hashlib.sha256()
        for k, v in sorted(state.model.state_dict().items()):
            h.update(k.encode())
            h.update(np.ascontiguousarray(v.detach().cpu().numpy()).tobytes())
        digests.append(h.hexdigest())
        return save(save_dir, epoch, state, logger)

    checkpoint.save_checkpoint = recording_save
    try:
        history = train.main(p['argv'])
    finally:
        checkpoint.save_checkpoint = save
    return {'history': history, 'digests': digests}


def model_digest(path: str) -> str:
    """The digest train_cli records, of a checkpoint file's model."""
    h = hashlib.sha256()
    state = torch.load(path, map_location='cpu', weights_only=True)['model']
    for k, v in sorted(state.items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v.numpy()).tobytes())
    return h.hexdigest()

"""The plain reference that decides ``correct``: the Segformer and SPNet
segmentors of the port, their train step and their input side, in float32
plain PyTorch (``data``, ``structure``, ``nn``, ``train``).

It imports neither JAX nor anything of the program: it is a frozen copy of
the port's plain paths, takes the benchmark's raw points and seeded
weights, voxelizes and builds its structure itself, and derives its
dropout and drop-path masks from the same seeds as the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import data, nn, train
from .nn import Segmentor, Spec, counting, precision

__all__ = ['Segmentor', 'Spec', 'counting', 'precision', 'build', 'tensors', 'eval_logits',
           'train_steps']


def build(cfg: dict, weights: dict, device) -> Segmentor:
    """The reference model on `device` with the given state dict."""
    model = Segmentor(Spec(cfg)).to(device)
    model.load_state_dict(weights)
    return model


def tensors(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


@torch.no_grad()
def eval_logits(model: Segmentor, frame: dict, cfg: dict, device) -> torch.Tensor:
    """[n, num_classes] point logits of one frame's n points."""
    model.eval()
    b = tensors(data.batch([frame], cfg, with_labels=False), device)
    return model(b)['point_out'][0, :frame['points'].shape[0]]


def train_steps(model: Segmentor, batches: list, cfg: dict, seed: int,
                schedule: dict) -> dict:
    """One train step a batch, step i on batches[i] ({'points', 'labels'}
    frames voxelized here) with dropout generator (seed, i) and the learning
    rate that the reference works out from the mix's `schedule`
    (``train.learning_rates``). Returns the losses, the first step's gradient
    of every parameter and the parameters after the last step (name ->
    tensor)."""
    device = next(model.parameters()).device
    spec = model.spec
    crit = train.criterion(cfg)
    aux_w = float(cfg['MODEL']['AUX_LOSS_WEIGHT'])
    tr = cfg['TRAIN']
    if tr['OPTIMIZER'] != 'sgd':
        raise NotImplementedError(f'the reference has no optimizer {tr["OPTIMIZER"]!r}')
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    bufs = [None] * len(params)
    lrs = train.learning_rates(cfg, schedule, len(batches))
    losses, first_grads = [], None
    model.train()
    for i, (frames, lr) in enumerate(zip(batches, lrs)):
        b = tensors(data.batch(frames, cfg, with_labels=True), device)
        for p in params:
            p.grad = None
        out = model(b, rng=train.step_generator(seed, i, device))
        value = train.loss(out, b, crit, spec, aux_w)
        value.backward()
        losses.append(float(value.detach()))
        if first_grads is None:
            first_grads = {n: p.grad.detach().clone() for n, p in zip(names, params)}
        del out, value
        train.sgd(params, bufs, lr, float(tr['MOMENTUM']), float(tr['WEIGHT_DECAY']))
    return {'losses': losses, 'grads': first_grads,
            'params': {n: p.detach() for n, p in zip(names, params)}}

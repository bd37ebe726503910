"""Segmentor construction, the loss, the train step and the eval step.

Counterpart of ``openseg3d_tpu/engine.py``. The serving path is
``forward(batch)['point_out']`` (``tools/test.py:72-74``); the eval step adds
the argmax, the IoU histogram and optionally the loss
(``engine.py:139-165``); the train step (``engine.py:99-136``) runs the
forward in training mode, the point, voxel and 0.4x aux losses
(``compute_loss``), the backward and the optimizer update, under the
non-finite-gradient guard.

From JAX to PyTorch:
  * ``TrainState`` holds the model (parameters and BatchNorm buffers), the
    optimizer (its state is optax's ``opt_state``), the schedule, ``step``
    (steps taken, skipped ones included) and ``updates`` (updates applied:
    optax's count, which drives the schedule).
  * The dropout randomness of step s comes from a ``torch.Generator`` on the
    model's device, freshly seeded from (seed, s), as
    ``jax.random.fold_in(rng, step)`` derives it.
  * Data-parallel training (``parallel/dist.py``) keeps the JAX package's
    SPMD meaning: the loss, the BatchNorm statistics and the eval histogram
    are those of the global batch.
  * The step updates the model in place (JAX returns a new state). When a
    gradient is not finite the update is dropped whole: the optimizer does
    not step (parameters, momentum buffers and the update count stay), and
    the BatchNorm running statistics the forward moved are restored; only
    ``step`` advances.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch

from .core.metrics import confusion_matrix
from .models.losses import build_criterion
from .models.optim import set_learning_rate
from .models.segmentors.common import ModelSpec
from .ops.knn import nearest_label_transfer
from .parallel.dist import all_reduce_sum, gather_rows, rank, reduce_gradients
from .utils.pointops import get_voxel_centers
from .utils.profiling import span


def build_segmentor(cfg, device='cuda'):
    """(model, spec) from a config, the model on `device` (the GPU unless the
    caller asks for the CPU; with no GPU, ``device='cuda'`` raises as torch
    does for a CUDA tensor). Its parameters are placeholders until
    ``weights.load_flax_variables`` or ``weights.init_weights`` fills them."""
    spec = ModelSpec.from_config(cfg)
    name = cfg.MODEL.SEGMENTOR
    if name == 'segformer':
        from .models.segmentors.segformer import Segformer
        return Segformer(spec).to(device), spec
    if name == 'spnet':
        from .models.segmentors.spnet import SPNet
        return SPNet(spec).to(device), spec
    raise NotImplementedError(name)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0          # train steps taken, skipped ones included
    updates: int = 0       # updates applied (optax's count): the schedule's input


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The dropout generator of one train step, a pure function of (seed,
    step) like ``jax.random.fold_in(rng, step)``; a rank past 0 is folded in
    too, so that the ranks draw different dropout and drop-path masks, as
    the shards of one SPMD batch do."""
    gen = torch.Generator(device=device)
    value = ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)
    if rank:
        value ^= (rank * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    gen.manual_seed(value)
    return gen


def _aux_labels(result, batch, spec: ModelSpec):
    """The stage-4 voxels' labels: each takes its nearest full-resolution
    voxel's label (B3 on the card)."""
    with span('aux_labels'), torch.no_grad():
        centers = get_voxel_centers(result['voxel_coords'], 1.0, spec.voxel_size,
                                    spec.point_cloud_range)
        aux_centers = get_voxel_centers(result['aux_voxel_coords'], 8.0, spec.voxel_size,
                                        spec.point_cloud_range)
        return nearest_label_transfer(centers, batch['voxel_labels'], result['voxel_mask'],
                                      aux_centers, result['aux_voxel_mask'])


def compute_loss(result, batch, criterion, spec: ModelSpec, aux_loss_weight: float,
                 aux_labels=None):
    """Point losses + voxel losses + aux_loss_weight x aux-voxel losses, the
    aux labels carried from the full-resolution voxels to the stage-4 voxels
    by the nearest voxel centre (``engine.py:67-96``), outside the gradient;
    or `aux_labels` ([B, A], this rank's) where the caller gives them (a
    reference run's own labels, ``parity.check_train_reference``).

    With more than one rank, the aux labels are found on each rank's own
    samples, then every rank's logits and labels are gathered in rank order
    (``parallel.dist.gather_rows``) and each criterion runs once on the
    global rows: the loss is the JAX package's loss of the global batch, the
    same on every rank."""
    nc = spec.num_classes
    if aux_labels is None:
        aux_labels = _aux_labels(result, batch, spec)
    loss = 0.0
    for out, labels, scale in ((result['point_out'], batch['point_labels'], 1.0),
                               (result['voxel_out'], batch['voxel_labels'], 1.0),
                               (result['aux_voxel_out'], aux_labels, aux_loss_weight)):
        out = gather_rows(out.reshape(-1, nc))
        labels = gather_rows(labels.reshape(-1))
        for fn, w in criterion:
            loss = loss + scale * w * fn(out, labels)
    return loss


def _grads_finite(params) -> bool:
    flags = [torch.isfinite(p.grad).all() for p in params if p.grad is not None]
    return bool(torch.stack(flags).all()) if flags else True


def make_train_step(cfg, spec: ModelSpec):
    """train_step(state, batch, seed) -> (state, {'loss', 'grads_finite'}).

    One forward in training mode, the loss, the backward, and (if every
    gradient is finite) one optimizer update at ``schedule(state.updates)``.
    With more than one rank the gradients are summed over the ranks first
    (``parallel.dist.reduce_gradients``), so every rank takes the same
    decision and the same update. The gradients stay in the parameters'
    ``.grad`` afterwards."""
    criterion = build_criterion(cfg)
    aux_w = float(cfg.MODEL.AUX_LOSS_WEIGHT)

    def train_step(state: TrainState, batch, seed: int = 0):
        with span('train_step', state.step):
            model = state.model
            device = next(model.parameters()).device
            model.train()
            # the BatchNorm running statistics as they were, for the guard
            stats = {name: b.clone() for name, b in model.named_buffers()}
            state.optimizer.zero_grad(set_to_none=True)
            with span('forward'):
                out = model(batch, rng=step_generator(seed, state.step, device, rank()))
            with span('loss'):
                loss = compute_loss(out, batch, criterion, spec, aux_w)
            with span('backward'):
                loss.backward()
            params = [p for group in state.optimizer.param_groups for p in group['params']]
            with span('grad_reduce'):
                reduce_gradients(params)
            with span('guard'):
                finite = _grads_finite(params)
            if finite:
                with span('optimizer'):
                    set_learning_rate(state.optimizer, state.schedule(state.updates))
                    state.optimizer.step()
                state.updates += 1
            else:
                with span('bn_restore'), torch.no_grad():
                    for name, b in model.named_buffers():
                        b.copy_(stats[name])
            state.step += 1
        return state, {'loss': loss.detach(), 'grads_finite': finite}

    return train_step


def make_forward(model: torch.nn.Module):
    """The serving forward: padded batch of tensors -> point logits
    [B, P, num_classes] (float32)."""
    calls = itertools.count()

    def forward(batch):
        model.eval()
        with span('forward', next(calls)), torch.inference_mode():
            return model(batch)['point_out']
    return forward


def make_eval_step(cfg, spec: ModelSpec, model: torch.nn.Module,
                   with_loss: bool = False):
    """Forward + argmax + IoU histogram over the valid current-frame points
    (``cur_point_mask & point_mask``, and ``sample_valid`` when the batch has
    it); with_loss adds ``compute_loss`` of the eval forward. With more than
    one rank the histogram is summed over the ranks and the loss is the
    global batch's, as the JAX package's replicated outputs are; the logits
    stay this rank's."""
    criterion = build_criterion(cfg) if with_loss else ()
    aux_w = float(cfg.MODEL.AUX_LOSS_WEIGHT)
    nc = spec.num_classes
    calls = itertools.count()

    def eval_step(batch):
        model.eval()
        with torch.inference_mode():
            with span('forward', next(calls)):
                out = model(batch)
            point_out = out['point_out']
            preds = point_out.argmax(dim=-1).reshape(-1)
            labels = batch['point_labels'].reshape(-1)
            valid = batch['cur_point_mask'] & batch['point_mask']
            if 'sample_valid' in batch:
                # exclude epoch-padding duplicate frames from the histogram
                valid = valid & batch['sample_valid'][:, None]
            hist = confusion_matrix(preds, labels, nc, valid.reshape(-1))
            res = {'hist': all_reduce_sum(hist), 'point_out': point_out}
            if with_loss:
                res['loss'] = compute_loss(out, batch, criterion, spec, aux_w)
        return res

    return eval_step

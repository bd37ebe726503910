"""The port's Segformer train step against the JAX package's, end to end.

The tiny Segformer of tests/test_torch_segformer.py (its variable tree from
``jax.eval_shape``, every leaf random) takes one train step on both sides, in
float32, from the same weights on the same batch:
  * dropout off on both sides: the port's rates set to 0, and flax's
    ``nn.Dropout.__call__`` patched to the identity for this test (the JAX
    package's files stay as they are); ``DROP_PATH_RATE`` 0;
  * the same aux labels on both sides: the JAX step gets the labels the
    port's 1-NN gave (the 1-NN has its own tests, in
    tests/test_torch_train_parts.py, since equidistant neighbours may
    resolve differently on the two sides);
  * the recipe's optimizer (``configs/waymo_one_sweep.yaml``: SGD, momentum
    0.9, weight decay 1e-4) with ``TRAIN.LR`` 50, so that the first
    update's learning rate, LR x the warmup factor 0.001, is the recipe's
    0.05 and the update is visible in the parameters.
Held equal: the loss, every gradient of the flax tree (through
``weights.to_flax_variables``), the new BatchNorm running statistics, and
the parameters after one SGD-momentum step (JAX: ``jax.value_and_grad`` of
the loss_fn of ``engine.make_train_step``, then the optax optimizer of
``models.optim``).

Tolerance: abs/rel 1e-4, as the forward parity test: float32 through ~40
layers and their backward in another summation order.

Also here: the non-finite-gradient guard, and the train path's launch
counters on the CPU (plain versions only, nothing counted).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openseg3d_tpu import engine as jax_engine
from openseg3d_tpu.models.losses import build_criterion as jax_build_criterion
from openseg3d_tpu.models.optim import build_optimizer as jax_build_optimizer
from openseg3d_tpu.models.optim import build_schedule as jax_build_schedule

from openseg3d_tpu_torch import engine
from openseg3d_tpu_torch.data.batch import to_device
from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_train_step
from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
from openseg3d_tpu_torch.models.segmentors.common import SegmentorHead
from openseg3d_tpu_torch.models.swformer import MLP, WindowAttention
from openseg3d_tpu_torch.ops.attention import (window_attention_train_backward,
                                               window_attention_train_forward)
from openseg3d_tpu_torch.ops.knn import nearest_point
from openseg3d_tpu_torch.weights import init_weights, load_flax_variables, to_flax_variables

from helpers import synthetic_batch, tiny_cfg
from test_torch_segformer import _randomise

TOL = dict(rtol=1e-4, atol=1e-4)
EPOCHS, ITERS = 2, 5


def _cfg(**model):
    return tiny_cfg(MODEL={'SEGMENTOR': 'segformer', 'DEPTHS': [2, 2, 2, 2],
                           'DROP_PATH_RATE': 0.0, **model},
                    TRAIN={'OPTIMIZER': 'sgd', 'LR': 50.0, 'MOMENTUM': 0.9,
                           'WEIGHT_DECAY': 1e-4})


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.attn_drop = 0.0
        elif isinstance(m, (MLP, SegmentorHead)):
            m.drop = 0.0


def _port_state(cfg, params, stats):
    model, spec = build_segmentor(cfg, device='cpu')
    load_flax_variables(model, params, stats)
    state = TrainState(model, build_optimizer(cfg, model.parameters()),
                       build_schedule(cfg, EPOCHS, ITERS))
    return state, spec


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_close(mine, ref, what):
    a, b = dict(_leaves(mine)), dict(_leaves(ref))
    assert set(a) == set(b), (what, sorted(set(a) ^ set(b))[:5])
    for path in sorted(b):
        np.testing.assert_allclose(a[path], b[path], err_msg=f'{what} {"/".join(path)}', **TOL)


def test_train_step_matches_jax(monkeypatch):
    cfg = _cfg()
    jmodel, jspec = jax_engine.build_segmentor(cfg)
    nb = synthetic_batch(cfg, batch_size=2, seed=3)
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != 'batch_size'}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            {'params': jax.random.PRNGKey(0)}, jb)
    rng = np.random.RandomState(0)
    params = _randomise(shapes['params'], rng)
    stats = _randomise(shapes['batch_stats'], rng)

    # the port: one train step, recording the aux labels its 1-NN gives
    state, spec = _port_state(cfg, params, stats)
    _no_dropout(state.model)
    aux = {}

    def recording_transfer(*args, **kwargs):
        aux['labels'] = engine_transfer(*args, **kwargs)
        return aux['labels']

    engine_transfer = engine.nearest_label_transfer
    monkeypatch.setattr(engine, 'nearest_label_transfer', recording_transfer)
    state, metrics = make_train_step(cfg, spec)(state, to_device(nb, 'cpu'), seed=0)
    assert metrics['grads_finite'] and (state.step, state.updates) == (1, 1)
    grads, _ = to_flax_variables(state.model, grads=True)
    new_params, new_stats = to_flax_variables(state.model)
    assert (aux['labels'] != 255).any()

    # JAX: no dropout, the same aux labels, value_and_grad + one optax update
    monkeypatch.setattr(fnn.Dropout, '__call__', lambda self, x, *a, **k: x)
    monkeypatch.setattr(jax_engine, 'nearest_label_transfer',
                        lambda *a, **k: jnp.asarray(aux['labels'].numpy()))
    criterion = jax_build_criterion(cfg)
    aux_w = float(cfg.MODEL.AUX_LOSS_WEIGHT)
    tx = jax_build_optimizer(cfg, jax_build_schedule(cfg, EPOCHS, ITERS))

    @jax.jit
    def jax_step(params, stats, batch):
        def loss_fn(p):
            out, mut = jmodel.apply({'params': p, 'batch_stats': stats}, batch, train=True,
                                    mutable=['batch_stats'],
                                    rngs={'dropout': jax.random.PRNGKey(0)})
            return jax_engine.compute_loss(out, batch, criterion, jspec, aux_w), \
                mut['batch_stats']
        (loss, new_stats), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(g, tx.init(params), params)
        return loss, g, new_stats, optax.apply_updates(params, updates)

    jloss, jgrads, jstats, jparams = jax.device_get(jax_step(params, stats, jb))

    np.testing.assert_allclose(float(metrics['loss']), float(jloss), **TOL)
    _assert_trees_close(grads, jgrads, 'grad')
    _assert_trees_close(new_stats, jstats, 'batch_stats')
    _assert_trees_close(new_params, jparams, 'params')
    update = max(float(np.abs(a - b).max())
                 for (_, a), (_, b) in zip(sorted(_leaves(jparams)), sorted(_leaves(params))))
    assert update > 1e-3, update                # the step moved the parameters


def _nan_batch(cfg):
    nb = synthetic_batch(cfg, batch_size=1, seed=4)
    nb['points'][0, 5, 3] = np.nan            # a feature column: coords stay finite
    return nb


def test_guard_drops_a_non_finite_update():
    """A NaN point makes the gradients non-finite: the update is dropped
    whole (params, momentum buffers, BatchNorm statistics as before), step
    advances and the update count, hence the schedule, does not."""
    cfg = _cfg()
    model, spec = build_segmentor(cfg, device='cpu')
    init_weights(model, torch.Generator().manual_seed(2))
    state = TrainState(model, build_optimizer(cfg, model.parameters()),
                       build_schedule(cfg, EPOCHS, ITERS))
    step = make_train_step(cfg, spec)
    state, m = step(state, to_device(synthetic_batch(cfg, batch_size=1, seed=1), 'cpu'))
    assert m['grads_finite'] and (state.step, state.updates) == (1, 1)

    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    momentum = {k: state.optimizer.state[p]['momentum_buffer'].clone()
                for k, p in model.named_parameters()}
    state, m = step(state, to_device(_nan_batch(cfg), 'cpu'))
    assert not m['grads_finite']
    assert (state.step, state.updates) == (2, 1)
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), params[k], rtol=0, atol=0)
        torch.testing.assert_close(state.optimizer.state[p]['momentum_buffer'], momentum[k],
                                   rtol=0, atol=0)
    for k, b in model.named_buffers():
        torch.testing.assert_close(b, buffers[k], rtol=0, atol=0)


def test_train_step_on_cpu_counts_no_kernel_launch():
    """On CPU tensors the train path runs the plain versions: none of the
    kernels' launch counters moves, and the step with dropout on is finite
    and reproducible from (seed, step)."""
    cfg = tiny_cfg(MODEL={'SEGMENTOR': 'segformer', 'DEPTHS': [2, 2, 2, 2]})
    batch = to_device(synthetic_batch(cfg, batch_size=1, seed=2), 'cpu')
    counters = (window_attention_train_forward, window_attention_train_backward,
                nearest_point)
    before = [c.launches for c in counters]
    losses = []
    for _ in range(2):
        model, spec = build_segmentor(cfg, device='cpu')
        init_weights(model, torch.Generator().manual_seed(5))
        state = TrainState(model, build_optimizer(cfg, model.parameters()),
                           build_schedule(cfg, EPOCHS, ITERS))
        state, m = make_train_step(cfg, spec)(state, batch, seed=7)
        assert m['grads_finite'] and torch.isfinite(m['loss'])
        losses.append(float(m['loss']))
    assert [c.launches for c in counters] == before
    assert losses[0] == losses[1]


def test_training_forward_needs_a_generator():
    cfg = _cfg()
    model, _ = build_segmentor(cfg, device='cpu')
    batch = to_device(synthetic_batch(cfg, batch_size=1, seed=2), 'cpu')
    with pytest.raises(ValueError, match='Generator'):
        model.train()(batch)
    with torch.inference_mode():
        assert torch.isfinite(model.eval()(batch)['point_out']).all()

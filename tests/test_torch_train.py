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
layers and their backward in another summation order. The same step in
bf16 (``RUNTIME.COMPUTE_DTYPE``) is held to the loss and the gradients at
tolerances scaled by JAX's own bf16-vs-float32 difference (see that test).

Also here: the non-finite-gradient guard, and the train path's launch
counters on the CPU (plain versions only, nothing counted).
"""

import functools
# The standard library's profiler module, imported while this file is
# collected: the first torch optimizer imports torch._dynamo, which imports
# cProfile and through it `profile`; tests/test_tools_and_utils.py puts the
# repository's tools/ (which holds a profile.py) at the front of sys.path
# while it runs, and a test file run after it in the same worker would
# otherwise get that script instead.
import profile  # noqa: F401

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
from openseg3d_tpu_torch.models.ocr import OCRLayer
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
BF16_LOSS_TOL = 1e-3
BF16_NOISE_FACTOR = 2.5
BF16_GLOBAL_FACTOR = 1.5
EPOCHS, ITERS = 2, 5


def _cfg(**extra):
    return tiny_cfg(MODEL={'SEGMENTOR': 'segformer', 'DEPTHS': [2, 2, 2, 2],
                           'DROP_PATH_RATE': 0.0},
                    TRAIN={'OPTIMIZER': 'sgd', 'LR': 50.0, 'MOMENTUM': 0.9,
                           'WEIGHT_DECAY': 1e-4}, **extra)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.attn_drop = 0.0
        elif isinstance(m, (MLP, SegmentorHead, OCRLayer)):
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


def _leaf_errors(mine, ref):
    """{leaf path: max |mine - ref| / max |ref|} over the flax tree."""
    a, b = dict(_leaves(mine)), dict(_leaves(ref))
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:5]
    return {'/'.join(p): float(np.abs(a[p] - b[p]).max()) / max(float(np.abs(b[p]).max()), 1e-30)
            for p in b}


def _step_both(monkeypatch, cfg, nb=None):
    """One train step of the port and of JAX from the same random weights
    on the same batch (default: two synthetic samples). Returns (port
    metrics, port grads, new stats, new params, JAX loss, grads, new stats,
    new params, the initial params)."""
    jmodel, jspec = jax_engine.build_segmentor(cfg)
    if nb is None:
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
    return metrics, grads, new_stats, new_params, jloss, jgrads, jstats, jparams, params


@pytest.fixture(scope='module')
def steps():
    """dtype -> _step_both at that RUNTIME.COMPUTE_DTYPE, each computed once
    for this module (the bf16 test reads the float32 JAX step as well)."""
    done = {}

    def get(dtype):
        if dtype not in done:
            with pytest.MonkeyPatch.context() as mp:
                done[dtype] = _step_both(mp, _cfg(RUNTIME={'COMPUTE_DTYPE': dtype}))
        return done[dtype]

    return get


def test_train_step_matches_jax(steps):
    metrics, grads, new_stats, new_params, jloss, jgrads, jstats, jparams, params = \
        steps('float32')
    np.testing.assert_allclose(float(metrics['loss']), float(jloss), **TOL)
    _assert_trees_close(grads, jgrads, 'grad')
    _assert_trees_close(new_stats, jstats, 'batch_stats')
    _assert_trees_close(new_params, jparams, 'params')
    update = max(float(np.abs(a - b).max())
                 for (_, a), (_, b) in zip(sorted(_leaves(jparams)), sorted(_leaves(params))))
    assert update > 1e-3, update                # the step moved the parameters


def _global_error(mine, ref):
    """|mine - ref| / |ref| over all leaves of the tree together (L2)."""
    a, b = dict(_leaves(mine)), dict(_leaves(ref))
    num = sum(float(np.square(a[p] - b[p]).sum()) for p in b)
    return (num / sum(float(np.square(b[p]).sum()) for p in b)) ** 0.5


def test_train_step_matches_jax_in_bf16(steps):
    """The same step at ``RUNTIME.COMPUTE_DTYPE`` bfloat16. The two packages
    round activations to bf16 at their own places, and at random weights
    bf16 rounding alone moves this tiny model's gradients a lot: JAX's own
    bf16 gradients differ from its float32 ones by ~0.18 over the whole
    tree (relative L2) and, per leaf, by up to the whole leaf where the
    true gradient is ~0 (conv biases ahead of BatchNorm). So each leaf is
    held against its largest magnitude, relative to that noise: the port's
    bf16 gradient may differ from JAX's bf16 one by at most BF16_NOISE_FACTOR
    times JAX's own bf16-vs-float32 difference on that leaf (the CPU shows
    at most 1.52 times, median 0.77); over the whole tree by at most
    BF16_GLOBAL_FACTOR times JAX's own (the CPU shows 0.78 times); the loss
    within BF16_LOSS_TOL (the CPU shows 4.5e-5, and JAX's own bf16 loss is
    7e-4 from its float32 one)."""
    metrics, grads, _, _, jloss, jgrads, _, _, _ = steps('bfloat16')
    jgrads32 = steps('float32')[5]
    assert metrics['grads_finite']
    loss_err = abs(float(metrics['loss']) - float(jloss)) / abs(float(jloss))
    errs, noise = _leaf_errors(grads, jgrads), _leaf_errors(jgrads, jgrads32)
    ratio = {p: errs[p] / max(noise[p], 1e-6) for p in errs}
    worst = max(ratio.items(), key=lambda kv: kv[1])
    conv = max((e, p) for p, e in errs.items() if 'SparseConv' in p and p.endswith('kernel'))
    glob, glob_noise = _global_error(grads, jgrads), _global_error(jgrads, jgrads32)
    print(f'bf16 step: loss rel {loss_err:.3g}; gradients rel L2 {glob:.3g} (JAX bf16 vs '
          f'float32: {glob_noise:.3g}); worst leaf against JAX\'s bf16 noise {worst[0]} '
          f'{worst[1]:.3g} ({errs[worst[0]]:.3g} vs {noise[worst[0]]:.3g}); worst sparse-conv '
          f'kernel {conv[1]} {conv[0]:.3g}')
    assert loss_err <= BF16_LOSS_TOL, loss_err
    assert glob <= BF16_GLOBAL_FACTOR * glob_noise, (glob, glob_noise)
    assert worst[1] <= BF16_NOISE_FACTOR, worst


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

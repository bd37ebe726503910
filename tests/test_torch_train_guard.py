"""The port's train step on its own: the non-finite-gradient guard, the
train path's launch counters on the CPU (plain versions only, nothing
counted), and the generator a training forward needs. The step against the
JAX package's is in tests/test_torch_train.py."""

import numpy as np
import pytest
import torch

from openseg3d_tpu_torch.data.batch import to_device
from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_train_step
from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
from openseg3d_tpu_torch.ops.attention import (window_attention_train_backward,
                                               window_attention_train_forward)
from openseg3d_tpu_torch.ops.knn import nearest_point
from openseg3d_tpu_torch.weights import init_weights

from helpers import synthetic_batch, tiny_cfg
from test_torch_train import EPOCHS, ITERS, _cfg


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    # the suite runs several test processes side by side on the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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

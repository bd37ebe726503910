"""The program's own spans (``utils.profiling.span``) and the benchmark's
readers of them.

  * With no profiler recording, a span enters no ``record_function``: a
    tiny Segformer train step, a tiny SPNet eval forward and the host input
    path run with ``seg3d.*`` ranges refused.
  * A CPU trace of a train step and of an eval forward holds every span of
    the program, nested as the program opens them, one ``seg3d.train_step``
    a step carrying its step number.
  * The spans change no output, loss, gradient or update.
  * Under ``benchmark.spans.installed``, every leaf operator inside the
    benchmark's attention and sparse-conv ranges and their backward nodes
    still has that range or node as its innermost one: the rooflines keep
    their kernels.
  * The readers of the new per-layer metrics and ``utils.profiling``'s idle
    gaps by span, on small hand-made chrome traces.
"""

import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run as bench_run
from benchmark import spans as bench_spans
from benchmark import trace as bench_trace
from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator
from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
from openseg3d_tpu_torch.engine import (TrainState, build_segmentor, make_forward,
                                        make_train_step)
from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
from openseg3d_tpu_torch.utils import profiling
from openseg3d_tpu_torch.weights import init_weights

from helpers import synthetic_batch, tiny_cfg

METRICS = Path(__file__).resolve().parent.parent / 'benchmark' / 'metrics'
SEGFORMER = {'SEGMENTOR': 'segformer', 'DEPTHS': [2, 2, 2, 2]}

# each span's parent: the innermost program span around it on its thread
TRAIN_PARENTS = {
    'seg3d.h2d': None,
    'seg3d.train_step': None,
    'seg3d.forward': 'seg3d.train_step',
    'seg3d.point_branch': 'seg3d.forward',
    'seg3d.structure': 'seg3d.forward',
    'seg3d.structure.rulebooks': 'seg3d.structure',
    'seg3d.structure.windows': 'seg3d.structure',
    'seg3d.backbone': 'seg3d.forward',
    'seg3d.window_permute': 'seg3d.backbone',
    'seg3d.attention': 'seg3d.backbone',
    'seg3d.sparse_conv': 'seg3d.backbone',
    'seg3d.head': 'seg3d.forward',
    'seg3d.loss': 'seg3d.train_step',
    'seg3d.aux_labels': 'seg3d.loss',
    'seg3d.backward': 'seg3d.train_step',
    'seg3d.grad_reduce': 'seg3d.train_step',
    'seg3d.guard': 'seg3d.train_step',
    'seg3d.optimizer': 'seg3d.train_step',
    'seg3d.bn_restore': 'seg3d.train_step',
}
EVAL_PARENTS = {
    'seg3d.voxelize': None,
    'seg3d.pad': None,
    'seg3d.h2d': None,
    'seg3d.forward': None,
    'seg3d.point_branch': 'seg3d.forward',
    'seg3d.structure': 'seg3d.forward',
    'seg3d.structure.rulebooks': 'seg3d.structure',
    'seg3d.backbone': 'seg3d.forward',
    'seg3d.sparse_conv': 'seg3d.backbone',
    'seg3d.head': 'seg3d.forward',
}


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    # the suite runs several test processes side by side on the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _nan_batch(cfg):
    nb = synthetic_batch(cfg, batch_size=1, seed=4)
    nb['points'][0, 5, 3] = np.nan            # a feature column: the gradients go non-finite
    return nb


def _train_run(batches):
    """A fresh seeded tiny Segformer: (its state after a train step on each
    batch, [(loss, finite)])."""
    cfg = tiny_cfg(MODEL=SEGFORMER)
    model, spec = build_segmentor(cfg, device='cpu')
    init_weights(model, torch.Generator().manual_seed(3))
    state = TrainState(model, build_optimizer(cfg, model.parameters()),
                       build_schedule(cfg, 1, 10))
    step = make_train_step(cfg, spec)
    out = []
    for batch in batches:
        state, m = step(state, to_device(batch, 'cpu'), seed=7)
        out.append((m['loss'], m['grads_finite']))
    return state, out


def _host_input(cfg, seed=0):
    """A raw cloud through the port's voxelizer, padding and copy."""
    rng = np.random.RandomState(seed)
    rg = np.array(cfg.DATASET.POINT_CLOUD_RANGE)
    xyz = rng.uniform(rg[:3] * 0.95, rg[3:] * 0.95, (600, 3))
    points = np.concatenate([xyz, rng.randn(600, cfg.DATASET.DIM_POINT - 3)], 1)
    points = points.astype(np.float32)
    coords, ids = VoxelGenerator(cfg.DATASET.VOXEL_SIZE,
                                 cfg.DATASET.POINT_CLOUD_RANGE).generate(points)
    sample = pad_sample(dict(points=points, voxel_coords=coords, point_voxel_ids=ids),
                        cfg.RUNTIME.MAX_POINTS_PER_SAMPLE, cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE)
    return to_device(collate_padded([sample]), 'cpu')


def _serve(frames=1):
    """A fresh seeded tiny SPNet: the point logits of `frames` served frames,
    raw points in."""
    cfg = tiny_cfg(MODEL={'SEGMENTOR': 'spnet'})
    model, _ = build_segmentor(cfg, device='cpu')
    init_weights(model, torch.Generator().manual_seed(4))
    forward = make_forward(model)
    return [forward(_host_input(cfg, seed)) for seed in range(frames)]


def _traced(fn):
    """(fn(), the chrome trace events of its run on the CPU)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _export(prof)


def _export(prof):
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return profiling.load_trace(path)
    finally:
        os.remove(path)


def _span_parents(events) -> list:
    """[(span, its parent span or None)] of the program's spans ('#<arg>'
    cut), by their nesting on each thread."""
    spans = sorted((e for e in events if e.get('cat') == 'user_annotation'
                    and e['name'].startswith(profiling.SPAN_PREFIX)),
                   key=lambda e: (str(e['tid']), e['ts'], -e['dur']))
    out, stack, tid = [], [], None
    for e in spans:
        if e['tid'] != tid:
            stack, tid = [], e['tid']
        while stack and stack[-1]['ts'] + stack[-1]['dur'] < e['ts'] + e['dur']:
            stack.pop()
        out.append((profiling.span_name(e['name']),
                    profiling.span_name(stack[-1]['name']) if stack else None))
        stack.append(e)
    return out


@pytest.fixture(scope='module')
def traced_train():
    """Two tiny Segformer train steps under the CPU profiler (the second
    non-finite: the guard restores the BatchNorm buffers): (the state after
    them, [(loss, finite)], events)."""
    cfg = tiny_cfg(MODEL=SEGFORMER)
    batches = [synthetic_batch(cfg, batch_size=1, seed=1), _nan_batch(cfg)]
    (state, steps), events = _traced(lambda: _train_run(batches))
    return state, steps, events


def test_no_span_enters_record_function_without_a_profiler(monkeypatch):
    real_init = torch.autograd.profiler.record_function.__init__

    def refuse(self, name, args=None):
        if name.startswith(profiling.SPAN_PREFIX):
            raise AssertionError(f'{name} entered a record_function')
        real_init(self, name, args)

    monkeypatch.setattr(torch.autograd.profiler.record_function, '__init__', refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    cfg = tiny_cfg(MODEL=SEGFORMER)
    _, steps = _train_run([synthetic_batch(cfg, batch_size=1, seed=1)])
    assert steps[0][1]
    assert _serve()[0].shape[-1] == 22
    # the same run under a profiler reaches the spans and is refused
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match='seg3d.'):
            _serve()


def test_a_train_step_trace_holds_every_span_nested(traced_train):
    _, steps, events = traced_train
    assert [finite for _, finite in steps] == [True, False]
    parents = _span_parents(events)
    assert {name for name, _ in parents} == set(TRAIN_PARENTS)
    for name, parent in parents:
        assert parent == TRAIN_PARENTS[name], (name, parent)
    names = [e['name'] for e in events if e.get('cat') == 'user_annotation']
    assert sorted(n for n in names if n.startswith('seg3d.train_step')) == [
        'seg3d.train_step#0', 'seg3d.train_step#1']
    # two permutes an encoder layer a step; the optimizer only in the finite step
    assert names.count('seg3d.window_permute') == 2 * 2 * sum(SEGFORMER['DEPTHS'])
    assert (names.count('seg3d.optimizer'), names.count('seg3d.bn_restore')) == (1, 1)


def test_an_eval_trace_holds_every_span_nested():
    _, events = _traced(lambda: _serve(frames=2))
    parents = _span_parents(events)
    assert {name for name, _ in parents} == set(EVAL_PARENTS)
    for name, parent in parents:
        assert parent == EVAL_PARENTS[name], (name, parent)
    names = [e['name'] for e in events if e.get('cat') == 'user_annotation']
    assert sorted(n for n in names if n.startswith('seg3d.forward')) == [
        'seg3d.forward#0', 'seg3d.forward#1']
    # per frame: pad_sample and collate_padded pad, one copy to the device
    assert (names.count('seg3d.pad'), names.count('seg3d.h2d')) == (4, 2)


def test_spans_change_no_output_loss_or_gradient(traced_train):
    cfg = tiny_cfg(MODEL=SEGFORMER)
    batches = [synthetic_batch(cfg, batch_size=1, seed=1), _nan_batch(cfg)]
    plain_state, plain = _train_run(batches)
    spanned_state, spanned, _ = traced_train
    for (a, fa), (b, fb) in zip(plain, spanned):
        assert fa == fb and torch.equal(a, b)
    named = dict(spanned_state.model.named_parameters())
    for n, p in plain_state.model.named_parameters():
        assert torch.equal(p, named[n]), n
        assert (p.grad is None) == (named[n].grad is None), n
        if p.grad is not None:      # the second step's gradients hold NaNs
            torch.testing.assert_close(p.grad, named[n].grad, rtol=0, atol=0, equal_nan=True)
    buffers = dict(spanned_state.model.named_buffers())
    for n, b in plain_state.model.named_buffers():
        assert torch.equal(b, buffers[n]), n
    plain_logits = _serve(frames=2)
    spanned_logits, _ = _traced(lambda: _serve(frames=2))
    for a, b in zip(plain_logits, spanned_logits):
        assert torch.equal(a, b)


def _leaf_ops(events):
    ops = sorted((e for e in events if e.get('cat') == 'cpu_op'),
                 key=lambda e: (str(e['tid']), e['ts'], -e['dur']))
    return [e for i, e in enumerate(ops)
            if i + 1 == len(ops) or ops[i + 1]['tid'] != e['tid']
            or ops[i + 1]['ts'] >= e['ts'] + e['dur']]


def test_the_benchmark_ranges_stay_innermost_around_their_layers():
    """What the rooflines read: each leaf operator inside a benchmark range
    of a layer, or in its backward node, has it as its innermost range."""
    cfg = tiny_cfg(MODEL=SEGFORMER)
    model, spec = build_segmentor(cfg, device='cpu')
    init_weights(model, torch.Generator().manual_seed(3))
    opt = build_optimizer(cfg, model.parameters())
    state = TrainState(model, opt, build_schedule(cfg, 1, 10))
    batch = to_device(synthetic_batch(cfg, batch_size=1, seed=1), 'cpu')

    def run():
        with bench_spans.installed(model, opt):
            make_train_step(cfg, spec)(state, batch, seed=7)
            make_forward(model)(batch)

    _, events = _traced(run)
    # the CPU's plain train attention is no autograd Function, so its
    # backward node (ATTENTION_BACKWARD) exists on the card only
    layers = (bench_spans.ATTENTION, bench_spans.SPARSE_CONV, bench_spans.SPARSE_CONV_BACKWARD)
    rngs = bench_trace.ranges(events)
    leaves = _leaf_ops(events)
    owners = bench_trace.innermost(rngs, [(e['tid'], e['ts']) for e in leaves])
    for layer in layers:
        inside = bench_trace.innermost([r for r in rngs if r[3] == layer],
                                       [(e['tid'], e['ts']) for e in leaves])
        held = [(e['name'], owner) for e, owner, within in zip(leaves, owners, inside)
                if within]
        assert held, layer
        assert all(owner == layer for _, owner in held), (layer, [
            h for h in held if h[1] != layer][:5])


# ---- the readers, on hand-made chrome traces ----

def _rng(name, tid, ts, dur):
    if name.startswith('backward: '):
        return dict(name=bench_trace.BACKWARD_NODE + name[len('backward: '):], cat='cpu_op',
                    tid=tid, ts=ts, dur=dur)
    return dict(name=name, cat='user_annotation', tid=tid, ts=ts, dur=dur)


def _call(name, tid, ts, corr=None, cat='cuda_runtime'):
    return dict(name=name, cat=cat, tid=tid, ts=ts, dur=1, args={'correlation': corr})


def _device(name, ts, dur, corr, cat='kernel'):
    return dict(name=name, cat=cat, tid=7, ts=ts, dur=dur, args={'correlation': corr})


def _read(metric, events, device='cuda', units=2):
    ctx = {'events': events, 'window_ms': 10.0, 'units': units, 'device': torch.device(device),
           'records': [], 'records_units': units, 'train': metric.endswith('.train')}
    return bench_run.load_module(METRICS / f'{metric}.py', metric).read(ctx)


STEP = [_rng('seg3d.train_step#4', 1, 0, 1000), _rng('seg3d.backward', 1, 380, 200)]

READER_CASES = {
    'launches on the main and the autograd threads': (
        'launches.train',
        STEP + [_rng('backward: MulBackward0', 2, 400, 100),
                _call('cudaLaunchKernel', 1, 100, 1),
                _call('cuLaunchKernel', 1, 200, 2, bench_trace.LAUNCH_CATEGORIES[1]),
                _call('cudaLaunchKernel', 2, 450, 3), _call('cudaLaunchKernel', 1, 2000, 4),
                _call('cudaMemsetAsync', 1, 300, 5)],
        1.5),
    'a D2H copy and its sync count once': (
        'host_syncs.train',
        STEP + [_call('cudaMemcpyAsync', 1, 300, 10), _call('cudaStreamSynchronize', 1, 301),
                _device('Memcpy DtoH (Device -> Pageable)', 302, 2, 10, 'gpu_memcpy')],
        0.5),
    'a pageable H2D copy counts, a pinned one does not': (
        'host_syncs.eval',
        [_rng('seg3d.h2d', 1, 0, 100), _call('cudaMemcpyAsync', 1, 10, 11),
         _call('cudaMemcpyAsync', 1, 20, 12),
         _device('Memcpy HtoD (Pageable -> Device)', 30, 2, 11, 'gpu_memcpy'),
         _device('Memcpy HtoD (Pinned -> Device)', 40, 2, 12, 'gpu_memcpy')],
        0.5),
    "the profiler's own syncs do not count": (
        'host_syncs.train',
        STEP + [_call('cudaDeviceSynchronize', 1, -50), _call('cudaStreamSynchronize', 1, 1500),
                _call('cudaEventSynchronize', 1, 1600), _call('cudaStreamSynchronize', 1, 900),
                _call('cudaMemcpy', 2, 420), _rng('backward: AddBackward0', 2, 400, 100)],
        1.0),
    'structure ms by the enclosing span': (
        'structure_ms.train',
        STEP + [_rng('seg3d.structure', 1, 100, 300), _rng('seg3d.structure.rulebooks', 1, 110, 90),
                _rng('bench.sparse_conv', 1, 300, 50),
                _call('cudaLaunchKernel', 1, 120, 1), _call('cudaLaunchKernel', 1, 320, 2),
                _call('cudaLaunchKernel', 1, 500, 3),
                _device('scan', 1000, 50, 1), _device('gather', 1100, 30, 2),
                _device('gemm', 1200, 100, 3)],
        0.04),
    'permute ms forward and backward': (
        'window_permute_ms.train',
        STEP + [_rng('seg3d.window_permute', 1, 100, 50),
                _rng('backward: _PermuteRowsBackward', 2, 400, 50),
                _rng('backward: _SparseConvBackward', 2, 460, 50),
                _call('cudaLaunchKernel', 1, 120, 1), _call('cudaLaunchKernel', 2, 420, 2),
                _call('cudaLaunchKernel', 2, 470, 3),
                _device('gather', 1000, 10, 1), _device('gather', 1100, 20, 2),
                _device('gemm', 1200, 40, 3)],
        0.015),
    'permute ms of a frame': (
        'window_permute_ms.eval',
        [_rng('seg3d.forward#0', 1, 0, 300), _rng('seg3d.window_permute', 1, 100, 50),
         _call('cudaLaunchKernel', 1, 120, 1), _call('cudaLaunchKernel', 1, 220, 2),
         _device('gather', 1000, 10, 1), _device('gemm', 1100, 40, 2)],
        0.005),
    'host ms in the copy to the card': (
        'h2d_ms.eval',
        [_rng('seg3d.h2d', 1, 0, 300), _rng('seg3d.h2d', 1, 1000, 500),
         _rng('seg3d.forward#0', 1, 2000, 100)],
        0.4),
}


@pytest.mark.parametrize('case', sorted(READER_CASES))
def test_reader_on_a_hand_made_trace(case):
    metric, events, expected = READER_CASES[case]
    assert _read(metric, events) == pytest.approx(expected)
    # off the card, and on a trace without the program's spans, nothing
    assert _read(metric, events, device='cpu') is None
    bare = [e for e in events if not e['name'].startswith(profiling.SPAN_PREFIX)]
    assert _read(metric, bare) is None


def test_idle_gaps_go_to_the_span_or_node_open_when_they_began():
    events = [
        _rng('seg3d.train_step#0', 1, 0, 1000), _rng('seg3d.forward', 1, 0, 300),
        _rng('seg3d.structure', 1, 50, 100), _rng('bench.forward', 1, 0, 300),
        _rng('seg3d.backward', 1, 400, 400), _rng('backward: _SparseConvBackward', 2, 450, 100),
        _device('a', 10, 40, 1), _device('b', 60, 10, 2), _device('c', 200, 10, 3),
        _device('d', 420, 10, 4), _device('e', 500, 10, 5), _device('f', 700, 10, 6),
        _device('g', 850, 10, 7), _device('h', 1200, 10, 8), _device('i', 1300, 10, 9),
    ]
    # gaps: 50-60 and 70-200 in the structure build, 210-420 in the forward,
    # 430-500 waiting on the backward before its node, 510-700 in the node,
    # 710-850 after it, 860-1200 in the step, 1210-1300 outside every span
    assert profiling.idle_by_span(events) == pytest.approx({
        'seg3d.structure': 0.14, 'seg3d.forward': 0.21, 'seg3d.backward': 0.21,
        'backward: _SparseConvBackward': 0.19, 'seg3d.train_step': 0.34, '(no span)': 0.09})
    res = profiling.analyze(events, steps=2)
    assert res['idle_by_span']['seg3d.train_step'] == pytest.approx(0.17)
    assert profiling.analyze(events, steps=2, cpu=True)['idle_by_span'] is None

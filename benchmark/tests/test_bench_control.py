"""The comparison that decides `correct` fails what it must: the control
(the reference with float8 matmul operands in the program's place) and
each fault a cell can have, planted under the timed path of a whole run of
a tiny cell on the CPU (the harness's look for a card skipped). The
control at the cells' own sizes runs on the card (`calibrate.py`)."""

import tempfile
from pathlib import Path
from unittest import mock

import pytest
import torch

import tiny
from benchmark import check as compare
from benchmark import run


@pytest.fixture(scope='module')
def bench():
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        yield tiny.make(Path(tmp))


def _run(bench, cell, seed=5, seconds=0.5):
    spec, bdir = bench
    return run.run_cell(spec, cell, seed, seconds, False, bdir, require_chip=False)


@pytest.mark.parametrize('cell', ['tiny.train', 'tinysp.train', 'tiny.eval', 'tinysp.eval'])
def test_a_sound_run_is_correct(bench, cell):
    assert _run(bench, cell)['correct']


@pytest.mark.parametrize('cell', ['tiny.train', 'tinysp.train'])
def test_the_control_fails_training(bench, cell):
    spec, bdir = bench
    c = run.Cell(spec, cell, bdir)
    s = c.loop.setup(run.Run(c, 5, torch.device('cpu'), False), 0.0)
    c.loop.release(s)
    ref = c.loop.reference_readings(s)
    control = c.loop.reference_readings(s, 'fp8')
    assert not compare.judge(compare.train_numbers(control, ref), c.limits)['correct']


@pytest.mark.parametrize('cell', ['tiny.eval', 'tinysp.eval'])
def test_the_control_fails_serving(bench, cell):
    spec, bdir = bench
    c = run.Cell(spec, cell, bdir)
    s = c.loop.setup(run.Run(c, 5, torch.device('cpu'), False), 0.0)
    c.loop.release(s)
    ref = c.loop.reference_logits(s)
    answers = [(i, lg.argmax(-1).to(torch.uint8).numpy())
               for i, lg in enumerate(c.loop.reference_logits(s, 'fp8'))]
    assert not compare.judge(c.loop.answers_gap(ref, answers), c.limits)['correct']


def test_a_step_that_leaves_the_state_unchanged_fails(bench):
    with mock.patch.object(torch.optim.SGD, 'step', lambda self, closure=None: None):
        result = _run(bench, 'tiny.train')
    assert not result['correct']
    change = {c['name']: c['value'] for c in result['compared']}['change_gap']
    assert change == pytest.approx(1.0)


@pytest.mark.parametrize('cell', ['tiny.train', 'tinysp.train'])
def test_one_layer_with_a_wrong_gradient_fails(bench, cell):
    """A fault that reaches one layer (a sparse conv's weight gradient
    doubled where the program makes it) leaves the median leaf as it was
    and fails on the worst leaf."""
    from openseg3d_tpu_torch import engine
    real = engine.build_segmentor

    def doubled(cfg, device):
        model, spec = real(cfg, device)
        kernels = [p for n, p in model.named_parameters() if n.endswith('SparseConv_0.kernel')]
        kernels[-1].register_hook(lambda g: 2 * g)
        return model, spec
    with mock.patch.object(engine, 'build_segmentor', doubled):
        result = _run(bench, cell)
    compared = {c['name']: c for c in result['compared']}
    assert not result['correct']
    assert compared['grad_gap_worst']['value'] > compared['grad_gap_worst']['limit']
    assert compared['grad_gap']['value'] <= compared['grad_gap']['limit']


@pytest.mark.parametrize('cell', ['tiny.train', 'tinysp.train'])
def test_half_the_batch_left_out_fails(bench, cell):
    from openseg3d_tpu_torch.data import batch as batch_mod
    real = batch_mod.to_device

    def half(batch, device):
        return {k: v[:1] for k, v in real(batch, device).items()}
    with mock.patch.object(batch_mod, 'to_device', half):
        assert not _run(bench, cell)['correct']


@pytest.mark.parametrize('cell', ['tiny.eval', 'tinysp.eval'])
def test_an_answer_altered_where_it_is_made_fails(bench, cell):
    from openseg3d_tpu_torch import engine
    real = engine.make_forward

    def altered(model):
        forward = real(model)

        def call(batch):
            out = forward(batch).clone()
            row = out[0, 0]
            out[0, 0] = torch.where(row == row.min(), row.max() + 1, row.min() - 1)
            return out
        return call
    with mock.patch.object(engine, 'make_forward', altered):
        assert not _run(bench, cell)['correct']

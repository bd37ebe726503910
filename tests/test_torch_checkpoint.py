"""A JAX run's orbax checkpoint in the port: the JAX package's own
``save_checkpoint`` writes a tiny Segformer's state after one SGD or AdamW
step (dropout off, fixed aux labels); the port imports it
(``utils/checkpoint``: tensorstore only, no JAX) and both sides take one more
step on the same batch: parameters and optimizer state within 1e-4 (see
``test_a_jax_checkpoint_resumes_in_the_port`` for AdamW). The train CLI's ``--auto_resume`` continues a
JAX save directory at the next epoch, directly and through
``tools.import_checkpoint``'s ``epoch_N.pt``; ``latest_checkpoint`` ranks
``.pt`` files and orbax directories by epoch; a host without tensorstore
gets an error naming the conversion route."""

import os
import shutil
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openseg3d_tpu import engine as jax_engine
from openseg3d_tpu.config import cfg_from_file as jax_cfg_from_file
from openseg3d_tpu.models.losses import build_criterion as jax_build_criterion
from openseg3d_tpu.models.optim import build_optimizer as jax_build_optimizer
from openseg3d_tpu.models.optim import build_schedule as jax_build_schedule
from openseg3d_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

from openseg3d_tpu_torch import engine, parity
from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.data.batch import to_device
from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_train_step
from openseg3d_tpu_torch.models.optim import (build_optimizer, build_schedule,
                                              set_learning_rate)
from openseg3d_tpu_torch.tools import import_checkpoint
from openseg3d_tpu_torch.tools import train as train_tool
from openseg3d_tpu_torch.utils import checkpoint
from openseg3d_tpu_torch.weights import (load_flax_variables, parameter_leaves,
                                         to_flax_variables)

from helpers import TINY_OVERRIDES, synthetic_batch
from test_torch_train import _leaves

TOL = dict(rtol=1e-4, atol=1e-4)
EPOCHS, ITERS = 2, 2       # the CLI's schedule: 2 epochs of 2 synthetic frames at batch 1
MOMENTS = {'sgd': {'trace': 'momentum_buffer'}, 'adamw': {'mu': 'exp_avg', 'nu': 'exp_avg_sq'}}


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _config_file(root, optimizer):
    ov = {k: dict(v) for k, v in TINY_OVERRIDES.items()}
    ov['MODEL'] = dict(ov['MODEL'], DEPTHS=[1, 1, 1, 1], DROP_PATH_RATE=0.0)
    ov['TRAIN'] = {'OPTIMIZER': optimizer, 'LR': 0.1, 'MOMENTUM': 0.9, 'WEIGHT_DECAY': 1e-4}
    path = os.path.join(root, f'{optimizer}.yaml')
    with open(path, 'w') as fh:
        yaml.safe_dump(ov, fh)
    return path


@pytest.fixture(scope='module')
def jax_runs(tmp_path_factory):
    """{optimizer: (config file, JAX save dir, batch, aux labels, the JAX
    gradients of step 2, the JAX states after step 1 and step 2)}: for SGD
    and AdamW, two JAX train steps (``engine.make_train_step``'s loss_fn
    and ``TrainState.apply_gradients``, dropout off, the port's aux
    labels) from the same weights on the same batch, the state after the
    first saved by the JAX package's ``save_checkpoint`` as epoch_1/. The
    gradient function is compiled once: the optimizer is not in it."""
    root = str(tmp_path_factory.mktemp('jax_runs'))
    cfg_files = {opt: _config_file(root, opt) for opt in MOMENTS}
    jcfg, cfg = jax_cfg_from_file(cfg_files['sgd']), cfg_from_file(cfg_files['sgd'])
    nb = synthetic_batch(jcfg, batch_size=2, seed=3)
    params, stats = parity.reference_weights(cfg, 2)

    # the aux labels of the port's 1-NN, fed to both sides
    model, spec = build_segmentor(cfg, device='cpu')
    load_flax_variables(model, params, stats)
    with torch.no_grad():
        model.eval()
        tb = to_device(nb, 'cpu')
        labels = engine._aux_labels(model(tb), tb, spec)

    jmodel, jspec = jax_engine.build_segmentor(jcfg)
    criterion = jax_build_criterion(jcfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != 'batch_size'}

    @jax.jit
    def grads(p, s, b):
        def loss_fn(p):
            out, mut = jmodel.apply({'params': p, 'batch_stats': s}, b, train=True,
                                    mutable=['batch_stats'],
                                    rngs={'dropout': jax.random.PRNGKey(0)})
            return jax_engine.compute_loss(out, b, criterion, jspec,
                                           float(jcfg.MODEL.AUX_LOSS_WEIGHT)), mut['batch_stats']
        (_, new_stats), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return g, new_stats

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, '__call__', lambda self, x, *a, **k: x)
        mp.setattr(jax_engine, 'nearest_label_transfer',
                   lambda *a, **k: jnp.asarray(labels.numpy()))
        for opt, cfg_file in cfg_files.items():
            ocfg = jax_cfg_from_file(cfg_file)
            tx = jax_build_optimizer(ocfg, jax_build_schedule(ocfg, EPOCHS, ITERS))
            state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                          batch_stats=stats, opt_state=tx.init(params), tx=tx,
                                          apply_fn=jmodel.apply)
            first = state.apply_gradients(*grads(state.params, state.batch_stats, jb))
            g2, s2 = grads(first.params, first.batch_stats, jb)
            second = first.apply_gradients(g2, s2)
            save = os.path.join(root, f'{opt}_run')
            os.makedirs(save)
            jax_save_checkpoint(save, 1, first)
            runs[opt] = (cfg_file, save, nb, labels, jax.device_get(g2), jax.device_get(first),
                         jax.device_get(second))
    return runs


def _port_state(cfg):
    model, _ = build_segmentor(cfg, device='cpu')
    parity.no_dropout(model)
    return TrainState(model, build_optimizer(cfg, model.parameters()),
                      build_schedule(cfg, EPOCHS, ITERS))


def _moments(opt_state):
    """{optax moment name: {flax path: array}} of a JAX opt_state."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(k, 'name', None) or getattr(k, 'key', None) for k in path]
        for i, n in enumerate(names):
            if n in ('trace', 'mu', 'nu'):
                out.setdefault(n, {})[tuple(names[i + 1:])] = np.asarray(leaf)
    return out


def _assert_state_matches(state, jstate, optimizer, stats=True, **tol):
    params, batch_stats = to_flax_variables(state.model)
    trees = [(params, jstate.params, 'params')]
    if stats:
        trees.append((batch_stats, jstate.batch_stats, 'batch_stats'))
    for mine, ref, what in trees:
        a, b = dict(_leaves(mine)), dict(_leaves(ref))
        assert set(a) == set(b), what
        for p in b:
            np.testing.assert_allclose(a[p], b[p], err_msg=f'{what} {"/".join(p)}', **tol)
    moments = _moments(jstate.opt_state)
    assert set(moments) == set(MOMENTS[optimizer])
    for moment, key in MOMENTS[optimizer].items():
        for path, param, fn in parameter_leaves(state.model):
            got = state.optimizer.state[param][key].numpy()
            np.testing.assert_allclose(got, np.asarray(fn(moments[moment][path])),
                                       err_msg=f'{moment} {"/".join(path)}', **tol)
    count = [int(c) for p, c in jax.tree_util.tree_flatten_with_path(jstate.opt_state)[0]
             if getattr(p[-1], 'name', None) == 'count']
    assert state.updates == count[0] and state.step == int(jstate.step)
    if optimizer == 'adamw':
        assert all(float(s['step']) == state.updates for s in state.optimizer.state.values())


@pytest.mark.parametrize('optimizer', sorted(MOMENTS))
def test_a_jax_checkpoint_resumes_in_the_port(jax_runs, optimizer):
    """Imported, the state equals the JAX state it was saved from, to the
    bit. Then one more step on each side: the optimizer's step on JAX's own
    second-step gradients gives JAX's parameters and moments within 1e-4
    (this isolates what the import carries: the moments, the update count
    that drives the schedule and AdamW's bias correction). With SGD the
    port's whole train step (its own forward and backward) does as well,
    the BatchNorm statistics included. AdamW's whole step is held in its
    BatchNorm statistics only: AdamW scales each element's update to about
    the learning rate whatever the gradient's size, so the elements whose
    gradient is rounding noise (conv biases ahead of BatchNorm, whose true
    gradient is zero) move by the learning rate in a direction that the
    rounding decides, on either side. load_model and load_pretrained read
    the same parameters."""
    cfg_file, save, nb, labels, g2, first, second = jax_runs[optimizer]
    cfg = cfg_from_file(cfg_file)
    path = checkpoint.latest_checkpoint(save)
    assert path == os.path.join(save, 'epoch_1')

    # the optimizer's step on JAX's gradients
    state, epoch = checkpoint.restore_checkpoint(path, _port_state(cfg))
    assert epoch == 1
    _assert_state_matches(state, first, optimizer, rtol=0, atol=0)
    flat_g2 = dict(_leaves(g2))
    for p, param, fn in parameter_leaves(state.model):
        param.grad = torch.from_numpy(np.array(fn(flat_g2[p]), np.float32))
    set_learning_rate(state.optimizer, state.schedule(state.updates))
    state.optimizer.step()
    state.step, state.updates = state.step + 1, state.updates + 1
    _assert_state_matches(state, second, optimizer, stats=False, **TOL)

    # the port's whole train step
    state, _ = checkpoint.restore_checkpoint(path, _port_state(cfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, 'nearest_label_transfer', lambda *a, **k: labels)
        state, metrics = make_train_step(cfg, build_segmentor(cfg, 'cpu')[1])(
            state, to_device(nb, 'cpu'), seed=0)
    assert metrics['grads_finite'] and (state.step, state.updates) == (2, 2)
    if optimizer == 'sgd':
        _assert_state_matches(state, second, optimizer, **TOL)
    else:
        got = dict(_leaves(to_flax_variables(state.model)[1]))
        for p, v in _leaves(second.batch_stats):
            np.testing.assert_allclose(got[p], v, err_msg='/'.join(p), **TOL)

    for load in (checkpoint.load_model, checkpoint.load_pretrained):
        model, _ = build_segmentor(cfg, device='cpu')
        load(path, model)
        got = dict(_leaves(to_flax_variables(model)[0]))
        for p, v in _leaves(first.params):
            np.testing.assert_array_equal(got[p], v, err_msg='/'.join(p))


def test_auto_resume_continues_a_jax_run(jax_runs, tmp_path):
    """The train CLI with --auto_resume over a JAX save directory (SGD)
    starts at epoch 2 with the imported counts; tools.import_checkpoint
    writes an epoch_1.pt (AdamW) equal to the direct import, and
    --auto_resume over its directory continues at epoch 2 as well."""
    def resume(cfg_file, save_dir):
        hist = train_tool.main([
            '--cfg_file', cfg_file, '--synthetic', '--synthetic_frames', str(ITERS),
            '--batch_size', '1', '--epochs', str(EPOCHS), '--num_workers', '0',
            '--no_validate', '--log_iter_interval', '1', '--seed', '0', '--device', 'cpu',
            '--auto_resume', '--save_dir', save_dir])
        assert [r[0] for r in hist['train']] == [EPOCHS] * ITERS, hist['train']
        # resumed at update count 1: the lr logged after the first step is
        # that of update count 2
        lr = build_schedule(cfg_from_file(cfg_file), EPOCHS, ITERS)
        assert hist['train'][0][2] == pytest.approx(lr(2))
        payload = torch.load(os.path.join(save_dir, f'epoch_{EPOCHS}.pt'), weights_only=True)
        assert (payload['epoch'], payload['step'], payload['updates']) == (EPOCHS, 3, 3)
        # the newest complete checkpoint is now the port's epoch_2.pt
        assert checkpoint.latest_checkpoint(save_dir) == os.path.join(save_dir, 'epoch_2.pt')

    cfg_file, jax_save, _, _, _, _, _ = jax_runs['sgd']
    save = str(tmp_path / 'jax_run')
    shutil.copytree(jax_save, save)
    resume(cfg_file, save)

    cfg_file, jax_save, _, _, _, first, _ = jax_runs['adamw']
    dst = str(tmp_path / 'imported')
    written = import_checkpoint.main([os.path.join(jax_save, 'epoch_1'), dst,
                                      '--cfg_file', cfg_file])
    assert written == os.path.join(dst, 'epoch_1.pt')
    state, epoch = checkpoint.restore_checkpoint(written, _port_state(cfg_from_file(cfg_file)))
    assert epoch == 1
    _assert_state_matches(state, first, 'adamw', rtol=0, atol=0)
    resume(cfg_file, dst)


def test_latest_checkpoint_ranks_pt_files_and_orbax_directories(tmp_path):
    """Highest epoch wins; a .pt wins a tie; an orbax directory without its
    manifest (a save cut off) and other names do not count."""
    def orbax(name, complete=True):
        os.makedirs(tmp_path / name)
        if complete:
            (tmp_path / name / 'manifest.ocdbt').write_bytes(b'')

    assert checkpoint.latest_checkpoint(str(tmp_path)) is None
    orbax('epoch_3')
    (tmp_path / 'epoch_2.pt').write_bytes(b'')
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / 'epoch_3')
    (tmp_path / 'epoch_3.pt').write_bytes(b'')
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / 'epoch_3.pt')
    orbax('epoch_9', complete=False)
    orbax('epoch_4.orbax-checkpoint-tmp-1')
    (tmp_path / 'epoch_7.pt.123.tmp').write_bytes(b'')
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / 'epoch_3.pt')
    orbax('epoch_10')
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / 'epoch_10')


def test_reading_orbax_without_tensorstore_names_the_route(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'tensorstore', None)
    with pytest.raises(ImportError, match='openseg3d_tpu_torch.tools.import_checkpoint'):
        checkpoint.read_orbax_checkpoint(str(tmp_path))

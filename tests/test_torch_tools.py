"""The port's command-line tools on the CPU, at the size of
configs/synthetic_smoke.yaml (full width, 2 layers per stage, 4096 points):
train writes its checkpoints and log; a resumed run ends in the same
checkpoint as an uninterrupted one (synthetic frame i is drawn from
RandomState(seed + i), the shuffle from the epoch, dropout from (seed, step),
so on one CPU every number repeats exactly); eval without TTA gives the
histogram of a direct eval step; eval with the 36-variant TTA runs (on a
smaller derived config: 36 forwards at the smoke size cost ~40 CPU-seconds);
the SPNet config trains and evaluates; and what is not ported raises. Torch
runs on 2 threads here: the suite runs several test processes side by side."""

import os
import shutil

import numpy as np
import pytest
import torch

from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.data.batch import collate_padded, to_device
from openseg3d_tpu_torch.data.synthetic import SyntheticDataset
from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_eval_step
from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
from openseg3d_tpu_torch.tools import eval as eval_tool
from openseg3d_tpu_torch.tools import train as train_tool
from openseg3d_tpu_torch.utils.checkpoint import (latest_checkpoint, load_pretrained,
                                                  restore_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, 'configs', 'synthetic_smoke.yaml')
TRAIN = ['--cfg_file', CFG, '--synthetic', '--synthetic_frames', '1', '--batch_size', '1',
         '--num_workers', '0', '--device', 'cpu', '--seed', '3', '--log_iter_interval', '1']


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _train(save_dir, *extra):
    return train_tool.main(TRAIN + ['--save_dir', str(save_dir), *extra])


@pytest.fixture(scope='module')
def trained(tmp_path_factory, two_threads):
    """Two epochs of one step, validated (on two frames) after the second."""
    save_dir = tmp_path_factory.mktemp('train')
    return save_dir, _train(save_dir, '--epochs', '2')


def _payload(path):
    return torch.load(path, map_location='cpu', weights_only=True)


def _assert_equal_payloads(a, b):
    assert (a['step'], a['updates'], a['epoch']) == (b['step'], b['updates'], b['epoch'])
    for k, v in a['model'].items():
        torch.testing.assert_close(v, b['model'][k], rtol=0, atol=0, msg=k)
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for k, v in sa[i].items():
            torch.testing.assert_close(v, sb[i][k], rtol=0, atol=0, msg=f'{i}/{k}')
    assert a['optimizer']['param_groups'] == b['optimizer']['param_groups']


def test_train_writes_checkpoints_and_log(trained):
    save_dir, history = trained
    assert sorted(os.listdir(save_dir)) == ['epoch_1.pt', 'epoch_2.pt', 'train.log']
    assert latest_checkpoint(str(save_dir)) == os.path.join(save_dir, 'epoch_2.pt')
    log = (save_dir / 'train.log').read_text()
    assert log.count('Train - Epoch [') == 2 and 'lr: ' in log and 'data-wait: ' in log
    assert 'Metrics on validation dataset: mIoU=' in log and 'training complete' in log
    assert [row[:2] for row in history['train']] == [(1, 1), (2, 1)]
    assert all(np.isfinite(row[3]) for row in history['train'])
    assert [epoch for epoch, _ in history['val']] == [2] and history['skipped'] == 0
    payload = _payload(save_dir / 'epoch_2.pt')
    assert (payload['step'], payload['updates'], payload['epoch']) == (2, 2, 2)


def test_resume_ends_in_the_same_checkpoint(trained, tmp_path):
    first, _ = trained
    for name in ('epoch_1.pt', 'epoch_2.pt'):
        shutil.copy(first / name, tmp_path / name)
    (tmp_path / 'epoch_2.pt').unlink()
    (tmp_path / 'epoch_2.pt.123.tmp').write_bytes(b'a save cut off')  # never taken
    history = _train(tmp_path, '--epochs', '2', '--auto_resume', '--deterministic')
    assert not torch.are_deterministic_algorithms_enabled()    # restored after the run
    assert [row[:2] for row in history['train']] == [(2, 1)]
    assert 'resumed from' in (tmp_path / 'train.log').read_text()
    _assert_equal_payloads(_payload(tmp_path / 'epoch_2.pt'), _payload(first / 'epoch_2.pt'))


def test_load_pretrained_matches_by_name_and_shape(trained):
    """Parameters whose name and shape match are copied; the rest, and the
    BatchNorm statistics, keep their values."""
    save_dir, _ = trained
    src = _payload(save_dir / 'epoch_2.pt')['model']
    tiny = os.path.join(REPO, 'configs', 'synthetic_smoke.yaml')
    model, _ = build_segmentor(cfg_from_file(tiny, overrides={'DATASET': {'DIM_POINT': 5}}),
                               device='cpu')
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained(str(save_dir / 'epoch_2.pt'), model)
    params = dict(model.named_parameters())
    copied = [k for k, p in params.items() if p.shape == src[k].shape]
    assert 0 < len(copied) < len(params)                  # the input layer differs
    for k, v in model.state_dict().items():
        want = src[k] if k in copied else before[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)


def test_eval_without_tta_equals_the_eval_step(trained):
    save_dir, _ = trained
    result = eval_tool.main(['--cfg_file', CFG, '--synthetic', '--synthetic_frames', '2',
                             '--no_tta', '--device', 'cpu', '--save_dir', str(save_dir)])
    cfg = cfg_from_file(CFG)
    model, spec = build_segmentor(cfg, device='cpu')
    restore_checkpoint(str(save_dir / 'epoch_2.pt'),
                       TrainState(model, build_optimizer(cfg, model.parameters()),
                                  build_schedule(cfg, 1, 1)))
    step = make_eval_step(cfg, spec, model)
    dataset = SyntheticDataset(cfg, 2, mode='validation')
    hist = sum(step(to_device(collate_padded([dataset.load_padded(i)[0]]), 'cpu'))['hist']
               for i in range(2))
    np.testing.assert_array_equal(result['hist'], hist.numpy())
    assert int(hist.sum()) == 2 * 4096 and np.isfinite(result['mIOU'])
    assert 'loaded' in (save_dir / 'eval.log').read_text()


def test_eval_with_tta(tmp_path):
    """The 36-variant TTA on one frame of a small config, random weights (no
    checkpoint in the save directory)."""
    cfg_file = tmp_path / 'tiny.yaml'
    cfg_file.write_text('DATASET: {POINT_CLOUD_RANGE: [-3.2, -3.2, -0.8, 3.2, 3.2, 0.8], '
                        'VOXEL_SIZE: [0.2, 0.2, 0.2]}\n'
                        'MODEL: {DEPTHS: [1, 1, 1, 1], WINDOW_SHAPE: [4, 4, 4]}\n'
                        'RUNTIME: {MAX_POINTS_PER_SAMPLE: 1024, MAX_VOXELS_PER_SAMPLE: 512, '
                        'COMPUTE_DTYPE: float32}\n')
    argv = ['--cfg_file', str(cfg_file), '--synthetic', '--synthetic_frames', '1',
            '--device', 'cpu', '--save_dir', str(tmp_path)]
    result = eval_tool.main(argv + ['--tta_batch', '12'])
    assert int(result['hist'].sum()) == 1024 and np.isfinite(result['mIOU'])
    assert 'evaluating random init' in (tmp_path / 'eval.log').read_text()
    with pytest.raises(ValueError, match='tta_batch'):
        eval_tool.main(argv + ['--tta_batch', '5'])


def test_tools_accept_the_spnet_config(tmp_path):
    """configs/synthetic_accuracy_spnet.yaml's model (SPNet, drop path
    0.05) through train and eval, on a small range and capacity: one step,
    a checkpoint holding the SPNet's tensors, and eval of that checkpoint."""
    cfg_file = tmp_path / 'spnet.yaml'
    text = open(os.path.join(REPO, 'configs', 'synthetic_accuracy_spnet.yaml')).read()
    cfg_file.write_text(text + 'DATASET: {POINT_CLOUD_RANGE: [-3.2, -3.2, -0.8, 3.2, 3.2, 0.8], '
                        'VOXEL_SIZE: [0.2, 0.2, 0.2]}\n'
                        'RUNTIME: {MAX_POINTS_PER_SAMPLE: 1024, MAX_VOXELS_PER_SAMPLE: 512, '
                        'COMPUTE_DTYPE: float32}\n')
    argv = ['--cfg_file', str(cfg_file), '--synthetic', '--synthetic_frames', '1',
            '--device', 'cpu', '--save_dir', str(tmp_path)]
    hist = train_tool.main(argv + ['--batch_size', '1', '--num_workers', '0', '--epochs', '1',
                                   '--no_validate', '--log_iter_interval', '1'])
    assert len(hist['train']) == 1 and np.isfinite(hist['train'][0][3])
    assert 'SparseUnet_0.OCRLayer_0.transform_kernel' in _payload(tmp_path / 'epoch_1.pt')['model']
    result = eval_tool.main(argv + ['--no_tta'])
    assert int(result['hist'].sum()) == 1024 and np.isfinite(result['mIOU'])


def test_what_is_not_ported_raises(tmp_path):
    with pytest.raises(NotImplementedError, match='A14'):
        eval_tool.main(['--synthetic', '--tta_device', '--device', 'cpu',
                        '--save_dir', str(tmp_path)])
    with pytest.raises(NotImplementedError, match='A10'):
        _train(tmp_path, '--num_devices', '2')
    with pytest.raises(NotImplementedError, match='A10'):
        _train(tmp_path, '--launcher', 'jax')
    if torch.cuda.is_available():
        return
    # the GPU is the default everywhere, and there is no fallback to the CPU
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_tool.main(TRAIN[:-6] + ['--save_dir', str(tmp_path)])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        eval_tool.main(['--synthetic', '--save_dir', str(tmp_path)])
    with pytest.raises((RuntimeError, AssertionError)):
        build_segmentor(cfg_from_file(CFG))

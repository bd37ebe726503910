"""The plain reference against the port's plain path on the CPU at a tiny
configuration (float32): the voxelizer, the forward, the loss, the
gradients and the SGD update. The reference imports nothing of the port;
this test imports both."""

import json
import statistics
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny
from benchmark import frames, reference, weights
from benchmark import check as compare
from benchmark.reference import data

RING = {'count': 4, 'min_points': 1000, 'max_points': 1400, 'num_classes': 22}


def _program(cfg_dict):
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.engine import build_segmentor
    cfg = cfg_from_file(None, overrides=cfg_dict)
    return (cfg,) + build_segmentor(cfg, 'cpu')


def _program_batch(ring, cfg):
    from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator
    from benchmark import run
    loop = run.load_module(tiny.BENCH / 'loops' / 'train.py', 'train')
    return loop.program_batch(ring, cfg, VoxelGenerator(cfg.DATASET.VOXEL_SIZE,
                                                        cfg.DATASET.POINT_CLOUD_RANGE))


def test_voxelizer_is_the_cpp_one():
    from openseg3d_tpu_torch import native
    from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator
    if not native.available():
        pytest.skip('the C++ voxelizer does not build here')
    cfg = json.load(open(tiny.ROOT / 'benchmark' / 'configs' / 'segformer_waymo.json'))['config']
    ds = cfg['DATASET']
    vg = VoxelGenerator(ds['VOXEL_SIZE'], ds['POINT_CLOUD_RANGE'])
    for f in frames.draw_ring({'count': 2, 'min_points': 150000, 'max_points': 180000,
                               'num_classes': 22}, 3):
        coords, ids = vg.generate(f['points'])
        rc, rids = data.voxelize(f['points'], ds['VOXEL_SIZE'], ds['POINT_CLOUD_RANGE'])
        assert np.array_equal(coords, rc) and np.array_equal(ids, rids)


def test_majority_labels_are_the_ports():
    from openseg3d_tpu_torch.core.voxelizer import majority_voxel_labels
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 50, 2000).astype(np.int32)
    labels = rng.integers(0, 4, 2000).astype(np.int32)
    assert np.array_equal(data.majority_labels(ids, labels, 60),
                          majority_voxel_labels(ids, labels, 60))


@pytest.mark.parametrize('segmentor', ['segformer', 'spnet'])
def test_state_dicts_match(segmentor):
    cfg_dict = tiny.tiny_config(segmentor)
    _, model, _ = _program(cfg_dict)
    ref = reference.Segmentor(reference.Spec(cfg_dict))
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize('segmentor', ['segformer', 'spnet'])
def test_eval_forward_matches_the_port(segmentor):
    from openseg3d_tpu_torch.data.batch import to_device
    from openseg3d_tpu_torch.engine import make_forward
    torch.set_num_threads(2)
    cfg_dict = tiny.tiny_config(segmentor)
    cfg, model, _ = _program(cfg_dict)
    w = weights.load(model, 4)
    ref = reference.build(cfg_dict, w, 'cpu')
    ring = frames.draw_ring(RING, 8)
    batch = _program_batch(ring[:1], cfg)
    got = make_forward(model)(to_device(batch, 'cpu'))[0, :ring[0]['points'].shape[0]]
    want = reference.eval_logits(ref, ring[0], cfg_dict, 'cpu')
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize('start_update', [0, 3, 9880, 9881, 355679])
def test_learning_rates_are_the_ports(start_update):
    """The reference works its learning rates out from the config and the
    mix's schedule alone; they equal the program's schedule at the same
    update counts, in the warm-up, where it ends and at the last update."""
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.models.optim import build_schedule
    cfg_dict = json.load(open(tiny.BENCH / 'configs' / 'segformer_waymo.json'))['config']
    mix = json.load(open(tiny.BENCH / 'traffic' / 'train_b2.json'))
    sch = dict(mix['schedule'], start_update=start_update)
    program = build_schedule(cfg_from_file(None, overrides=cfg_dict), int(sch['epochs']),
                             int(sch['iters_per_epoch']))
    got = reference.train.learning_rates(cfg_dict, sch, 3)
    assert got == pytest.approx([program(start_update + i) for i in range(3)], rel=1e-12)
    assert got[0] > 0 or start_update >= int(sch['epochs']) * int(sch['iters_per_epoch']) - 1


def test_bf16_witness_rounds_values_and_cotangents():
    x = torch.randn(1000, requires_grad=True)
    with reference.precision('bf16'):
        y = reference.nn.rnd(x)
    assert torch.equal(y, x.detach().to(torch.bfloat16).float())
    g = torch.randn(1000)
    y.backward(g)
    assert torch.equal(x.grad, g.to(torch.bfloat16).float())
    assert reference.nn.rnd(x) is x


@pytest.mark.parametrize('segmentor', ['segformer', 'spnet'])
def test_train_steps_match_the_port(segmentor):
    """Three steps of the port's train step (the benchmark's own loop set-up)
    against the reference's: losses, first gradients and the change."""
    from benchmark import run
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        spec, bench = tiny.make(Path(tmp))
        name = 'tiny' if segmentor == 'segformer' else 'tinysp'
        cell = run.Cell(spec, f'{name}.train', bench)
        r = run.Run(cell, 21, torch.device('cpu'), False)
        s = cell.loop.setup(r, 0.0)
        cell.loop.release(s)
        ref = cell.loop.reference_readings(s)
    numbers = compare.train_numbers(s.readings, ref)
    assert numbers['loss_gap'] < 1e-5, numbers
    assert numbers['grad_gap'] < 1e-4, numbers
    assert numbers['change_gap'] < 1e-4, numbers
    assert statistics.median(ref['change_norms'].values()) > 0


@pytest.mark.cuda
def test_fp8_control_rounds_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    x = torch.randn(1000, device='cuda')
    with reference.precision('fp8'):
        y = reference.nn.rnd(x)
    rel = float(((y - x).abs() / x.abs().clamp(min=1e-3)).median())
    assert 1e-3 < rel < 0.1

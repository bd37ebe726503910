"""The port's measuring entry points against the JAX package's.

  * ``openseg3d_tpu_torch.bench``: its batch equals the JAX bench's array for
    array (the JAX bench's own ``main`` builds it here, stopped before its
    model: one sweep, multi-sweep, cylinder, image features); ``main`` runs
    each mode on the CPU and prints one JSON line whose rate is its step time;
  * ``utils.profiling``: buckets and attribution of a hand-made trace;
    ``tools.profile_step --device cpu`` gives a by-module table with the
    program's spans, the same again from ``--analyze_only``, and its ranges
    change no output;
  * ``tools.measure_capacities``: per-stage voxel counts and per (stage,
    shift, level) window counts equal those of the JAX package's jitted
    ``build_downsample`` and ``window_coords`` on a 16384-point bench frame,
    and both tools print the same suggestions;
  * ``tools.verify_capacities``: the same lines and verdict as the JAX tool.
"""

import contextlib
import functools
import io
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import bench as jax_bench
from openseg3d_tpu import native
from openseg3d_tpu.ops import sparse_conv as jax_sparse_conv
from openseg3d_tpu.ops import window as jax_window
from tools import measure_capacities as jax_measure
from tools import verify_capacities as jax_verify

from openseg3d_tpu_torch import bench
from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator
from openseg3d_tpu_torch import native as port_native
from openseg3d_tpu_torch.data.batch import to_device
from openseg3d_tpu_torch.data.synthetic import make_waymo_like_cloud
from openseg3d_tpu_torch.engine import build_segmentor
from openseg3d_tpu_torch.models.segmentors.common import ModelSpec
from openseg3d_tpu_torch.tools import measure_capacities, profile_step, verify_capacities
from openseg3d_tpu_torch.utils import profiling
from openseg3d_tpu_torch.weights import init_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs', 'synthetic_smoke.yaml')
SMALL = ['--n_points', '4096', '--max_voxels', '4096']
CAPACITY_FRAME = ['--frames', '1', '--n_points', '16384', '--max_voxels', '16384']
BENCH_FIELDS = {'metric', 'value', 'unit', 'vs_baseline', 'step_ms', 'first_step_s', 'build_s',
                'gpu', 'power_limit_w', 'device', 'launches_per_step'}


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    # the suite runs several test processes side by side on the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def jax_host_paths(monkeypatch):
    """The JAX tools with no change to this process's JAX settings; both
    packages voxelize on the same path (their C++ voxelizer where it
    builds: the port's is a copy of the JAX package's)."""
    assert native.available() == port_native.available()
    monkeypatch.setattr(jax.config, 'update', lambda *args: None)
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', os.path.join(REPO, '.jax_test_cache'))


def _run_main(monkeypatch, main, argv, name):
    """(stdout, result) of a JAX tool's main() run with argv."""
    monkeypatch.setattr(sys, 'argv', [name] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main()
    return out.getvalue(), result


class _Stop(Exception):
    pass


def _jax_bench_batch(monkeypatch, argv):
    """The padded batch that the JAX bench's main builds from argv: its
    collate_padded is recorded, and the run stops there."""
    from openseg3d_tpu.data import batch as jax_batch
    seen = {}
    collate = jax_batch.collate_padded

    def record(samples):
        seen['batch'] = collate(samples)
        raise _Stop

    monkeypatch.setattr(jax_batch, 'collate_padded', record)
    monkeypatch.setattr(sys, 'argv', ['bench.py'] + argv)
    with pytest.raises(_Stop):
        jax_bench.main()
    return seen['batch']


@pytest.mark.parametrize('cfg_file,extra', [
    ('waymo_one_sweep.yaml', ['--batch_size', '2']),
    ('waymo_multi_sweeps.yaml', []),
    ('waymo_one_sweep_cylinder.yaml', []),
    ('waymo_one_sweep.yaml', ['--image_feature']),
])
def test_bench_batch_equals_the_jax_bench(monkeypatch, cfg_file, extra):
    argv = ['--cfg_file', os.path.join(REPO, 'configs', cfg_file), '--n_points', '6000',
            '--max_voxels', '8192'] + extra
    want = _jax_bench_batch(monkeypatch, argv)
    args = bench.parse_args(argv)
    got, n_voxels = bench.bench_batch(bench.bench_config(args), args.batch_size, args.n_points,
                                      args.max_voxels, args.image_feature)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert n_voxels == [int(n) for n in want['num_voxels']]
    if 'multi' in cfg_file:
        assert want['cur_point_mask'].sum() < want['point_mask'].sum()


def test_bench_batch_equals_the_jax_bench_on_numpy(monkeypatch):
    """The same with both packages on their numpy voxelizer."""
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(port_native, 'available', lambda: False)
    test_bench_batch_equals_the_jax_bench(monkeypatch, 'waymo_one_sweep.yaml',
                                          ['--batch_size', '2'])


@pytest.mark.parametrize('mode', ['infer', 'train_fwd', 'train'])
def test_bench_main_prints_one_json_line(capsys, mode):
    result = bench.main(['--device', 'cpu', '--cfg_file', SMOKE, '--iters', '1',
                         '--mode', mode] + SMALL)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == BENCH_FIELDS
    assert result['unit'] == 'Mpoints/sec' and result['device'] == 'cpu'
    assert result['gpu'] is result['power_limit_w'] is result['build_s'] is None
    assert result['metric'].startswith(f'segformer end-to-end {mode} throughput')
    # the rate is batch x points over the step, within the two fields' rounding
    rate = 4096 / (result['step_ms'] * 1e3)
    assert abs(result['value'] - rate) <= 5e-5 + rate * 5e-4 / result['step_ms']
    assert result['first_step_s'] > 0
    # on the CPU every wrapper runs its plain version: nothing launched
    assert set(result['launches_per_step'].values()) == {0}


def _trace_events():
    """A hand-made chrome trace of one step: forward ranges on thread 1, an
    autograd node on thread 2, kernels linked to their launches."""
    def rng(name, tid, ts, dur, cat='user_annotation'):
        return dict(name=name, cat=cat, tid=tid, ts=ts, dur=dur)

    def launch(tid, ts, corr, name='cudaLaunchKernel'):
        return dict(name=name, cat='cuda_runtime', tid=tid, ts=ts, dur=1, args={'correlation': corr})

    def kernel(name, ts, dur, corr, cat='kernel'):
        return dict(name=name, cat=cat, tid=7, ts=ts, dur=dur, args={'correlation': corr})

    return [
        rng('profile_step#0', 1, 0, 1000),
        rng('PointTransformer_0.SWFormerBlock_0', 1, 100, 200),
        rng('window_partition_0', 1, 110, 20),
        rng('autograd::engine::evaluate_function: _SparseConvBackward', 2, 400, 100,
            cat='cpu_op'),
        launch(1, 105, 1), launch(1, 115, 2), launch(1, 350, 3), launch(2, 450, 4),
        launch(1, 600, 5, 'cudaMemcpyAsync'), launch(1, 610, 6, 'cudaMemsetAsync'),
        launch(1, 2000, 7),
        kernel('void window_attention_mma_kernel<24>(...)', 120, 2000, 1),
        kernel('void at::native::vectorized_gather_kernel<16, long>(...)', 2500, 500, 2),
        kernel('nearest_point_kernel', 3500, 250, 3),
        kernel('sm90_xmma_gemm_bf16bf16_bf16f32', 3600, 1000, 4),    # overlaps the one before
        kernel('Memcpy DtoD (Device -> Device)', 5000, 100, 5, 'gpu_memcpy'),
        kernel('Memset (Device)', 5200, 50, 6, 'gpu_memset'),
        kernel('void at::native::reduce_kernel<512, 1>(...)', 6000, 100, 7),
        kernel('void at::native::elementwise_kernel<128, 2>(...)', 6200, 10, 99),   # no launch
    ]


def test_profiling_buckets_and_attributes_a_hand_made_trace():
    res = profiling.analyze(_trace_events(), top=3)
    assert res['steps'] == 1
    assert res['device_ms_per_step'] == pytest.approx(4.01)
    assert res['busy_ms_per_step'] == pytest.approx(4.01 - 0.15)
    assert res['by_bucket'] == pytest.approx({
        'attention': 2.0, 'gemm': 1.0, 'gather': 0.5, 'knn': 0.25, 'copy': 0.1,
        'reduce': 0.1, 'memset': 0.05, 'elementwise': 0.01})
    assert [(row[0].split('(')[0], row[2]) for row in res['top']] == [
        ('void window_attention_mma_kernel<24>', 1), ('sm90_xmma_gemm_bf16bf16_bf16f32', 1),
        ('void at::native::vectorized_gather_kernel<16, long>', 1)]
    assert res['by_module'] == pytest.approx({
        'PointTransformer_0.SWFormerBlock_0': 2.0,
        'backward: _SparseConvBackward': 1.0,
        'window_partition_0': 0.5,
        '(no range)': 0.25 + 0.1 + 0.05 + 0.1 + 0.01})
    assert profiling.kernel_name('_Z27window_attention_mma_kernelILi24EEvPK13__nv_bfloat16') \
        == 'window_attention_mma_kernel<24>'
    assert profiling.kernel_name('_Z37window_attention_train_fwd_mma_kernelILi48ELi32EEvPK13__'
                                 'nv_bfloat16') == 'window_attention_train_fwd_mma_kernel<48, 32>'


def test_profile_step_on_cpu_gives_a_by_module_table(tmp_path, capsys):
    argv = ['--device', 'cpu', '--cfg_file', SMOKE, '--mode', 'infer', '--steps', '1',
            '--by_module', '--trace_dir', str(tmp_path)] + SMALL
    res = profile_step.main(argv)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == res
    mods = res['by_module']
    for name in ('PointBranch_0.PointEncoder_0', 'PointTransformer_0.ConvModule_0',
                 'PointTransformer_0.SWFormerBlock_3', 'PointTransformer_0.UpBlock_3',
                 'SegmentorHead_0.LinearBNReLU_0', 'seg3d.structure.rulebooks',
                 'seg3d.structure.windows', 'seg3d.sparse_conv', 'seg3d.window_permute'):
        assert mods.get(name, 0) > 0, (name, sorted(mods))
    assert sum(mods.values()) == pytest.approx(res['device_ms_per_step'])
    again = profile_step.main(['--analyze_only', '--trace_dir', str(tmp_path)])
    assert again['by_module'] == pytest.approx(mods)

    # the ranges change no output
    cfg = cfg_from_file(SMOKE)
    model, _ = build_segmentor(cfg, device='cpu')
    init_weights(model, torch.Generator().manual_seed(0))
    batch = to_device(bench.bench_batch(cfg, 1, 4096, 2048)[0], 'cpu')
    model.eval()
    with torch.inference_mode():
        plain = model(batch)
        with profiling.module_ranges(model):
            ranged = model(batch)
    for k in plain:
        assert torch.equal(plain[k], ranged[k]), k


def _jax_structure(monkeypatch):
    """Per stage voxel counts and window ids of the JAX tool's run, through
    jitted build_downsample and window_coords."""
    seen = {'num_out': [], 'windows': []}
    build = jax_sparse_conv.build_downsample

    @functools.partial(jax.jit, static_argnums=1)
    def down(st, out_capacity):
        plan = build(st, out_capacity=out_capacity)
        return plan.out_coords, plan.num_out

    coords = jax.jit(jax_window.window_coords, static_argnums=(2, 3, 4))

    def build_downsample(st, out_capacity):
        out_coords, num_out = down(st, out_capacity)
        seen['num_out'].append(int(num_out[0]))
        return types.SimpleNamespace(out_coords=out_coords, num_out=num_out,
                                     out_shape=jax_sparse_conv.downsample_shape(
                                         st.spatial_shape, 3, 2, 1))

    def window_coords(cc, valid, shape, wshape, shift):
        out = coords(cc, valid, tuple(shape), tuple(wshape), shift)
        seen['windows'].append(np.asarray(out[0])[np.asarray(valid)])
        return out

    monkeypatch.setattr(jax_sparse_conv, 'build_downsample', build_downsample)
    monkeypatch.setattr(jax_window, 'window_coords', window_coords)
    return seen


def test_measure_capacities_matches_jax(monkeypatch, capsys):
    seen = _jax_structure(monkeypatch)
    jax_out, _ = _run_main(monkeypatch, jax_measure.main, CAPACITY_FRAME, 'measure_capacities')
    res = measure_capacities.main(['--device', 'cpu'] + CAPACITY_FRAME)
    assert capsys.readouterr().out == jax_out

    # the frame again, counted per (stage, shift, level)
    cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml'),
                        overrides={'RUNTIME': {'MAX_POINTS_PER_SAMPLE': 16384,
                                               'MAX_VOXELS_PER_SAMPLE': 16384}})
    spec = ModelSpec.from_config(cfg)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    coords, _ = vg.generate(make_waymo_like_cloud(np.random.RandomState(1), 16384))
    occupancy, windows, tokens = measure_capacities.frame_counts(coords, spec, 16384, 'cpu')
    assert occupancy == [coords.shape[0]] + seen['num_out'] == res['occupancy']
    want = np.zeros_like(windows)
    for i, win in enumerate(seen['windows']):
        s, shift = divmod(i, 2)
        _, cnts = np.unique(win, return_counts=True)
        for li, (_, (t, lo, hi)) in enumerate(spec.batching_info[s]):
            want[s, shift, li] = ((cnts >= lo) & (cnts < hi)).sum()
    np.testing.assert_array_equal(windows, want)
    assert windows.sum() > 0 and windows[:, 0].tolist() != windows[:, 1].tolist()
    np.testing.assert_array_equal(windows.max(axis=1), res['windows'])
    np.testing.assert_array_equal(tokens.max(axis=1), res['tokens'])


@pytest.mark.parametrize('max_voxels', ['16384', '98304'])
def test_verify_capacities_matches_jax(monkeypatch, capsys, max_voxels):
    argv = ['--frames', '1', '--n_points', '16384', '--max_voxels', max_voxels]
    jax_out, rc = _run_main(monkeypatch, jax_verify.main, argv, 'verify_capacities')
    res = verify_capacities.main(argv)
    assert capsys.readouterr().out == jax_out
    assert (res['violations'] == 0) == (rc == 0)
    if max_voxels == '16384':
        assert res['violations'] > 0

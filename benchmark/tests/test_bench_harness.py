"""The harness: BENCHMARK.json against the contract's naming rules, the
metrics each cell reports, files found by name (a new mix is data only),
and no JAX in what the harness loads."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tiny

ROOT = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _names():
    for section in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in SPEC[section]:
            yield entry['name']
    for w in SPEC['workloads']:
        yield w['config']
        yield w['traffic']
    for c in SPEC['configs']:
        yield from c['reduced']


@pytest.mark.parametrize('name', sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize('metric', SPEC['end_to_end'] + SPEC['per_layer'],
                         ids=lambda m: m['name'])
def test_units_and_fields(metric):
    assert UNIT.match(metric['unit']), metric['unit']
    assert metric['better'] in ('lower', 'higher')
    if metric in SPEC['end_to_end']:
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
    else:
        assert metric['source'] in ('device_trace', 'program_span', 'program_counter',
                                    'host_clock')


def _reports(cell, metric):
    return cell in metric.get('workloads', [cell])


@pytest.mark.parametrize('metric', SPEC['per_layer'], ids=lambda m: m['name'])
def test_every_cell_of_a_layer_metric_reports_what_it_moves(metric):
    """Each per-layer metric names its cells, and each of them reports the
    end-to-end metric it moves."""
    moved = {m['name']: m for m in SPEC['end_to_end']}[metric['moves']]
    cells = metric['workloads']
    assert cells and set(cells) <= {w['name'] for w in SPEC['workloads']}, cells
    for cell in cells:
        assert _reports(cell, moved), (metric['name'], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    from benchmark import run
    for w in SPEC['workloads']:
        cell = run.Cell(SPEC, w['name'], ROOT / 'benchmark')
        e2e = {m['name'] for m in cell.metrics('end_to_end')}
        assert 'setup_s' in e2e and len(e2e) >= 2, w['name']
        assert cell.metrics('per_layer'), w['name']


def test_files_are_found_by_name():
    from benchmark import run
    for w in SPEC['workloads']:
        cell = run.Cell(SPEC, w['name'], ROOT / 'benchmark')
        assert cell.loop_name in ('train', 'eval')
        assert cell.limits
        for m in cell.metrics('per_layer'):
            assert callable(run.load_module(ROOT / 'benchmark' / 'metrics' / f'{m["name"]}.py',
                                            m['name']).read)


def test_a_new_mix_is_data_only(tmp_path):
    """A throwaway mix file and a cell naming it, in a copy of the
    benchmark, run with no code edit."""
    from benchmark import run
    torch.set_num_threads(2)
    spec, bench = tiny.make(tmp_path)
    (bench / 'traffic' / 'throwaway.json').write_text(json.dumps(
        {'loop': 'eval', 'frames': {'count': 2, 'min_points': 700, 'max_points': 900,
                                    'num_classes': 22}}))
    spec['workloads'].append({'name': 'tiny.throwaway', 'config': 'tiny',
                              'traffic': 'throwaway', 'chips': 1, 'why': 'test'})
    for m in spec['end_to_end']:
        if m['name'].startswith('eval_'):
            m['workloads'].append('tiny.throwaway')
    result = run.run_cell(spec, 'tiny.throwaway', 5, 0.5, False, bench, require_chip=False)
    assert result['correct'] and result['attempted'] >= 1
    assert {'eval_frames_s', 'eval_ms_p95', 'setup_s'} <= set(result['metrics'])
    assert list(result)[-1] == 'compared'


NO_JAX = r'''
import sys, json
sys.path.insert(0, sys.argv[1])
from pathlib import Path
from benchmark import run, calibrate, counts, trace, spans, weights, frames, check, reference
import openseg3d_tpu_torch.engine, openseg3d_tpu_torch.core.voxelizer, openseg3d_tpu_torch.data.batch
import openseg3d_tpu_torch.models.optim, openseg3d_tpu_torch.ops._build, openseg3d_tpu_torch.native
bench = Path(sys.argv[1]) / 'benchmark'
for loop in ('train', 'eval'):
    run.load_module(bench / 'loops' / f'{loop}.py', loop)
for m in (bench / 'metrics').glob('*.py'):
    run.load_module(m, m.stem)
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
'''


def test_nothing_loaded_is_jax():
    out = subprocess.run([sys.executable, '-c', NO_JAX, str(ROOT)], capture_output=True,
                         text=True, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {'jax', 'jaxlib', 'flax', 'openseg3d_tpu'}, tops & {'jax', 'openseg3d_tpu'}
    assert 'openseg3d_tpu_torch' in tops


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    proc = subprocess.run([sys.executable, str(ROOT / 'benchmark' / 'run.py'), '--workload',
                           'segformer.eval', '--seed', '1', '--seconds', '1', '--trace', '0'],
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and not proc.stdout.strip()

"""A new architecture joins the benchmark as new files only: in a tiny copy
of the benchmark, a throwaway reference, a configuration file that names
it and its limits files, and two cells appended to the spec, run through
both loops with no file of the copy or of the benchmark edited. And cells
the tiny copy does not know leave its own cells, and what they read, as
they were."""

import hashlib
import json
from pathlib import Path
from unittest import mock

import pytest
import torch

import tiny
from benchmark import run

SEVEN = ('Spec', 'Segmentor', 'build', 'eval_logits', 'train_steps', 'counting', 'precision')

THROWAWAY = f'''"""A throwaway architecture's reference: the package's seven names, each
call counted in CALLS."""
import collections

from benchmark import reference as package

CALLS = collections.Counter()


def _counted(name):
    real = getattr(package, name)

    def call(*args, **kwargs):
        CALLS[name] += 1
        return real(*args, **kwargs)
    return call


{', '.join(SEVEN)} = (_counted(name) for name in {SEVEN!r})
'''

REEXPORT = f'from benchmark.reference import {", ".join(SEVEN)}  # noqa: F401\n'

# what each loop calls of its reference in a run with the trace flag
CALLED = {'train': {'Spec', 'Segmentor', 'build', 'train_steps', 'counting', 'precision'},
          'eval': {'Spec', 'Segmentor', 'build', 'eval_logits', 'counting', 'precision'}}


REPORTED = {'train': ('train_step_ms', 'mfu.train'),
            'eval': ('eval_frames_s', 'eval_ms_p95', 'mfu.eval')}


def append_cells(spec: dict, config: str, traffic: dict) -> None:
    """Appends a configuration, its cells (cell name -> (mix, loop)) and
    their names to the metrics they report."""
    spec['configs'].append({'name': config, 'source': 'test', 'reduced': [], 'why': 'test',
                            'file': f'benchmark/configs/{config}.json'})
    for cell, (mix, loop) in traffic.items():
        spec['workloads'].append({'name': cell, 'config': config, 'traffic': mix,
                                  'chips': 1, 'why': 'test'})
        for m in spec['end_to_end'] + spec['per_layer']:
            if m['name'] in REPORTED[loop]:
                m['workloads'].append(cell)


def add_architecture(spec: dict, bench: Path) -> dict:
    """Writes a throwaway architecture's files into a tiny benchmark copy
    (its reference, a configuration file naming it, the limits of both
    loops), appends its cells newarch.train and newarch.eval to `spec`;
    returns the new files."""
    files = {bench / 'reference' / 'throwaway.py': THROWAWAY,
             bench / 'configs' / 'newarch.json': json.dumps(
                 {'config': tiny.tiny_config('segformer'), 'reference': 'throwaway'})}
    for loop, limits in tiny.LIMITS.items():
        files[bench / 'limits' / f'newarch.{loop}.json'] = json.dumps({'limits': limits})
    for path, text in files.items():
        path.write_text(text)
    append_cells(spec, 'newarch',
                 {f'newarch.{loop}': (f'tiny_{loop}', loop) for loop in tiny.LIMITS})
    return files


def _files(*roots: Path) -> dict:
    """Every file under the roots but bytecode caches, with its digest."""
    out = {}
    for root in roots:
        paths = root.rglob('*') if root.is_dir() else [root]
        for p in paths:
            if p.is_file() and '__pycache__' not in p.parts:
                out[p] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


@pytest.mark.parametrize('loop', ['train', 'eval'])
def test_a_new_architecture_is_new_files_only(tmp_path, loop):
    """The throwaway's cell of each loop runs correct through its own
    reference, and the run adds no file and changes none."""
    torch.set_num_threads(2)
    spec, bench = tiny.make(tmp_path)
    before = _files(tmp_path, tiny.BENCH, tiny.ROOT / 'BENCHMARK.json')
    added = add_architecture(spec, bench)
    written = _files(tmp_path, tiny.BENCH, tiny.ROOT / 'BENCHMARK.json')
    assert set(written) - set(before) == set(added)
    assert all(written[p] == before[p] for p in before)
    loaded, real = [], run.load_reference

    def load_reference(name, bench_dir):
        loaded.append(real(name, bench_dir))
        return loaded[-1]
    with mock.patch.object(run, 'load_reference', load_reference):
        cell = run.Cell(spec, f'newarch.{loop}', bench)
        assert {m['name'] for m in cell.metrics('per_layer')} >= {f'mfu.{loop}'}
        result = run.run_cell(spec, f'newarch.{loop}', 5, 0.0, True, bench, require_chip=False)
    assert result['correct'], result['compared']
    calls = loaded[-1].CALLS
    assert {n for n in SEVEN if calls[n]} == CALLED[loop], calls
    assert _files(tmp_path, tiny.BENCH, tiny.ROOT / 'BENCHMARK.json') == written


def test_cells_it_does_not_know_leave_the_tiny_cells_as_they_were(tmp_path):
    """With a new architecture's configuration and cells in the spec,
    tiny.make builds the same four cells; and the tiny cells read the same
    numbers, bit for bit, through a reference file that re-exports the
    package."""
    torch.set_num_threads(2)
    spec, bench = tiny.make(tmp_path / 'a')
    wider = json.loads((tiny.ROOT / 'BENCHMARK.json').read_text())
    append_cells(wider, 'newarch_waymo', {'newarch.train': ('train_b2', 'train'),
                                          'newarch.eval': ('eval_frame', 'eval')})
    assert tiny.make(tmp_path / 'b', spec=wider)[0] == spec
    assert (tmp_path / 'b' / 'BENCHMARK.json').read_bytes() == \
        (tmp_path / 'a' / 'BENCHMARK.json').read_bytes()
    configs = {k: (name, dict(content, reference='reexport'))
               for k, (name, content) in tiny.default_configs().items()}
    spec_c, bench_c = tiny.make(tmp_path / 'c', configs=configs)
    (bench_c / 'reference' / 'reexport.py').write_text(REEXPORT)
    for cell in ('tiny.train', 'tiny.eval'):
        package = run.run_cell(spec, cell, 5, 0.0, False, bench, require_chip=False)
        by_file = run.run_cell(spec_c, cell, 5, 0.0, False, bench_c, require_chip=False)
        assert package['correct'] and by_file['correct']
        assert by_file['numbers'] == package['numbers'], (package['numbers'],
                                                          by_file['numbers'])

"""A tiny copy of the benchmark for CPU tests: the harness, loops,
metrics and reference as they are, with small configurations, mixes and a
spec of their own in a temporary directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
LIMITS = {'train': {'grad_gap': 1e-3, 'change_gap': 1e-3,
                    'grad_gap_worst': 1e-2, 'change_gap_worst': 1e-2},
          'eval': {'label_regret': 1e-3}}


def tiny_config(segmentor: str) -> dict:
    from openseg3d_tpu_torch.config import cfg_from_file
    levels = {'0': {'max_tokens': 16, 'batching_range': [0, 16]},
              '1': {'max_tokens': 64, 'batching_range': [16, 100000]}}
    cfg = cfg_from_file(str(ROOT / 'configs' / 'synthetic_smoke.yaml'), overrides={
        'MODEL': {'SEGMENTOR': segmentor, 'BATCHING_INFO': [levels] * 4},
        'DATASET': {'POINT_CLOUD_RANGE': [-76.8, -76.8, -2.0, 76.8, 76.8, 4.4],
                    'VOXEL_SIZE': [1.6, 1.6, 1.6]},
        'RUNTIME': {'MAX_POINTS_PER_SAMPLE': 1536, 'MAX_VOXELS_PER_SAMPLE': 1024,
                    'WINDOW_BUCKET_FRACTIONS': [[1.0, 0.5]] * 4},
        'TRAIN': {'OPTIMIZER': 'sgd', 'LR': 0.05, 'WEIGHT_DECAY': 0.0001}})
    return json.loads(json.dumps(cfg))


def default_configs() -> dict:
    """The committed configurations' tiny stand-ins: Segformer as `tiny`,
    SPNet as `tinysp`."""
    return {'segformer_waymo': ('tiny', {'config': tiny_config('segformer')}),
            'spnet_waymo': ('tinysp', {'config': tiny_config('spnet')})}


def make(tmp: Path, configs: dict | None = None, spec: dict | None = None) -> tuple[dict, Path]:
    """(spec, bench dir) of a tiny benchmark under tmp. `configs` maps a
    configuration of `spec` (default: ``BENCHMARK.json``) to its tiny
    stand-in, (name, configuration file content: ``config`` and an optional
    ``reference``); default `default_configs()`, which gives the cells
    tiny.train, tiny.eval (Segformer) and tinysp.train, tinysp.eval (SPNet).
    Each stand-in gets a cell a loop; each metric lists the stand-ins of the
    cells it lists, and drops the cells of configurations with none."""
    bench = tmp / 'benchmark'
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    spec = json.loads(json.dumps(spec)) if spec is not None \
        else json.loads((ROOT / 'BENCHMARK.json').read_text())
    configs = default_configs() if configs is None else configs
    frames = {'count': 6, 'min_points': 1000, 'max_points': 1400, 'num_classes': 22}
    (bench / 'traffic' / 'tiny_train.json').write_text(json.dumps({
        'loop': 'train', 'batch_size': 2, 'frames': frames,
        'schedule': {'epochs': 2, 'iters_per_epoch': 10, 'start_update': 10}}))
    (bench / 'traffic' / 'tiny_eval.json').write_text(json.dumps({'loop': 'eval',
                                                                  'frames': frames}))
    tiny_cells = {}
    for w in spec['workloads']:
        if w['config'] in configs:
            loop = json.loads((BENCH / 'traffic' / f'{w["traffic"]}.json').read_text())['loop']
            tiny_cells[w['name']] = f'{configs[w["config"]][0]}.{loop}'
    spec['configs'], spec['workloads'] = [], []
    for name, content in configs.values():
        (bench / 'configs' / f'{name}.json').write_text(json.dumps(content))
        spec['configs'].append({'name': name, 'source': 'test', 'file':
                                f'benchmark/configs/{name}.json', 'reduced': [], 'why': 'test'})
        for loop, limits in LIMITS.items():
            (bench / 'limits' / f'{name}.{loop}.json').write_text(json.dumps({'limits': limits}))
            spec['workloads'].append({'name': f'{name}.{loop}', 'config': name,
                                      'traffic': f'tiny_{loop}', 'chips': 1, 'why': 'test'})
    for m in spec['end_to_end'] + spec['per_layer']:
        if 'workloads' in m:
            m['workloads'] = list(dict.fromkeys(tiny_cells[w] for w in m['workloads']
                                                if w in tiny_cells))
    (tmp / 'BENCHMARK.json').write_text(json.dumps(spec))
    return spec, bench

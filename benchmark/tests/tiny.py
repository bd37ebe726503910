"""A tiny copy of the benchmark for CPU tests: the harness, loops,
metrics and reference as they are, with small configurations, mixes and a
spec of their own in a temporary directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


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


def make(tmp: Path) -> tuple[dict, Path]:
    """(spec, bench dir) of a tiny benchmark under tmp: cells tiny.train,
    tiny.eval (Segformer) and tinysp.train, tinysp.eval (SPNet)."""
    bench = tmp / 'benchmark'
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    frames = {'count': 6, 'min_points': 1000, 'max_points': 1400, 'num_classes': 22}
    (bench / 'traffic' / 'tiny_train.json').write_text(json.dumps({
        'loop': 'train', 'batch_size': 2, 'frames': frames,
        'schedule': {'epochs': 2, 'iters_per_epoch': 10, 'start_update': 10}}))
    (bench / 'traffic' / 'tiny_eval.json').write_text(json.dumps({'loop': 'eval',
                                                                  'frames': frames}))
    spec['configs'], spec['workloads'] = [], []
    for name, seg in (('tiny', 'segformer'), ('tinysp', 'spnet')):
        (bench / 'configs' / f'{name}.json').write_text(json.dumps(
            {'config': tiny_config(seg)}))
        spec['configs'].append({'name': name, 'source': 'test', 'file':
                                f'benchmark/configs/{name}.json', 'reduced': [], 'why': 'test'})
        for loop, limits in (('train', {'grad_gap': 1e-3, 'change_gap': 1e-3,
                                        'grad_gap_worst': 1e-2, 'change_gap_worst': 1e-2}),
                             ('eval', {'label_regret': 1e-3})):
            (bench / 'limits' / f'{name}.{loop}.json').write_text(json.dumps({'limits': limits}))
            spec['workloads'].append({'name': f'{name}.{loop}', 'config': name,
                                      'traffic': f'tiny_{loop}', 'chips': 1, 'why': 'test'})
    tiny_cells = {'segformer.train': 'tiny.train', 'spnet.train': 'tinysp.train',
                  'segformer.eval': 'tiny.eval', 'spnet.eval': 'tinysp.eval'}
    for m in spec['end_to_end'] + spec['per_layer']:
        if 'workloads' in m:
            m['workloads'] = [tiny_cells[w] for w in m['workloads']]
    (tmp / 'BENCHMARK.json').write_text(json.dumps(spec))
    return spec, bench

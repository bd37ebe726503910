"""Profile eval forwards or train steps of the port and attribute the device
time to kernels, buckets and modules.

    python -m openseg3d_tpu_torch.tools.profile_step --mode train --steps 2 --by_module
    python -m openseg3d_tpu_torch.tools.profile_step --mode infer --trace_dir runs/prof
    python -m openseg3d_tpu_torch.tools.profile_step --analyze_only --trace_dir runs/prof

Counterpart of the JAX package's ``tools/profile.py`` (named so that it
cannot shadow the standard library's ``profile`` when its folder is on
``sys.path``). It builds the JAX bench's frame (``bench.bench_batch``, batch
1) and the port's model with seeded random weights, runs one untraced step
(kernel build and first launches), then ``--steps`` steps under
``torch.profiler``, each in a ``profile_step#i`` range, and prints
``utils.profiling.analyze``'s report: device ms a step in all, by bucket,
the top operations, by innermost range, and on the card the idle gaps by
program span. The last line is the same numbers as one JSON object. The
chrome trace is kept in ``--trace_dir``; ``--analyze_only`` reads it again.

The program's own spans (``utils.profiling.span``: ``seg3d.structure``,
``seg3d.loss``, ``seg3d.window_permute``, ...) record whenever the profiler
does. ``--by_module`` takes the place of the JAX tool's ``--hlo``/``--dump_hlo``
join onto HLO provenance: it adds ``record_function`` ranges around the
segmentor and its submodules two levels down (the point branch, the stem
``ConvModule_0``, each stage's ``SWFormerBlock_s`` and downsample
``ConvModule_s``, the decoder's ``UpBlock``s, the head). A kernel goes to
the innermost range or span around its launch; in the backward, to the
autograd node that launched it. On the card the report also puts each of
the device's idle gaps to the program span (or, in the backward, the
autograd node) open when it began. The ranges change no output.

``--device cpu`` runs on the CPU (the plain versions; its "device" events
are the leaf operators), for tests; on ``cuda`` (the default) a trace
without device events fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile

TRACE_FILE = 'trace.json'


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='Profile the port: device time by kernel, bucket '
                                             'and module')
    ap.add_argument('--mode', choices=['infer', 'train'], default='train')
    ap.add_argument('--n_points', type=int, default=163840)
    ap.add_argument('--max_voxels', type=int, default=98304)
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--segmentor', default='segformer')
    ap.add_argument('--cfg_file', default='configs/waymo_one_sweep.yaml')
    ap.add_argument('--trace_dir', default=os.path.join(tempfile.gettempdir(),
                                                        'openseg3d_torch_trace'),
                    help=f'the chrome trace is written there as {TRACE_FILE}')
    ap.add_argument('--top', type=int, default=30)
    ap.add_argument('--analyze_only', action='store_true',
                    help='just re-read the trace in --trace_dir')
    ap.add_argument('--by_module', action='store_true',
                    help='record_function ranges around the modules two levels down; time '
                         'by innermost range or program span')
    ap.add_argument('--image_feature', action='store_true',
                    help='enable DATASET.USE_IMAGE_FEATURE (DeepFusion)')
    ap.add_argument('--device', default='cuda',
                    help="torch device: 'cuda' (default) or 'cpu'")
    # the JAX bench's flags that this tool fixes
    ap.set_defaults(batch_size=1, stage_ratios='', losses='')
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Profiles (or with --analyze_only re-reads) and prints the report;
    returns ``utils.profiling.analyze``'s dict."""
    args = parse_args(argv)
    from ..utils import profiling
    path = os.path.join(args.trace_dir, TRACE_FILE)
    if args.analyze_only:
        events = profiling.load_trace(path)
        cpu = not any(e.get('cat') == 'kernel' for e in events)
        result = profiling.analyze(events, steps=args.steps, top=args.top, cpu=cpu)
    else:
        result = _profile(args, path)
    profiling.report(result, top=args.top)
    print(json.dumps(result), flush=True)
    return result


def _profile(args, path) -> dict:
    import torch
    from torch.profiler import record_function

    from ..bench import bench_batch, bench_config, card_identity, make_step
    from ..data.batch import to_device
    from ..engine import build_segmentor
    from ..utils import profiling
    from ..weights import init_weights
    from .train import resolve_device

    device = resolve_device(args.device)
    cfg = bench_config(args)
    batch, n_voxels = bench_batch(cfg, 1, args.n_points, args.max_voxels, args.image_feature)
    batch = to_device(batch, device)
    model, spec = build_segmentor(cfg, device)
    init_weights(model, torch.Generator().manual_seed(0))
    step = make_step(args.mode, cfg, model, spec, batch, device)
    step()          # builds the kernels, first launches
    os.makedirs(args.trace_dir, exist_ok=True)

    def steps():
        for i in range(args.steps):
            with record_function(f'{profiling.STEP_RANGE}{i}'):
                step()

    with profiling.module_ranges(model) if args.by_module else contextlib.nullcontext():
        events, wall = profiling.trace(steps, device.type, path)
    cpu = device.type == 'cpu'
    if not cpu and not any(e.get('cat') == 'kernel' for e in events):
        raise RuntimeError('the trace holds no kernel: the profiler did not trace the card')
    gpu, power_limit_w = card_identity(device)
    print(f'{args.steps} traced {args.mode} steps, {n_voxels[0]} voxels: {wall:.1f} ms wall '
          f'(tracing inflates it; the times below are the trace\'s), on {gpu or "the CPU"}'
          + ('' if power_limit_w is None else f' at {power_limit_w} W'), flush=True)
    return dict(profiling.analyze(events, args.steps, args.top, cpu), gpu=gpu,
                power_limit_w=power_limit_w)


if __name__ == '__main__':
    main()

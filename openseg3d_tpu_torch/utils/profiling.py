"""Device time from a ``torch.profiler`` trace: by kernel, by bucket, by module.

Counterpart of ``analyze`` in ``tools/profile.py``, which reads the serial
``XLA Ops`` line of a TPU trace. Here the device events of a chrome trace
are the kernels, copies and memsets (``cat`` ``kernel``, ``gpu_memcpy``,
``gpu_memset``); each is linked by its ``correlation`` id to the runtime call
on the host that launched it. A trace of a run on the CPU has no device
events: there the leaf operators (``cpu_op`` events with no operator inside
them) stand in for them, so that the same report comes out of a CPU run.

``analyze`` sums them per step:
  * by bucket (``bucket``): the port's kernels by name (``attention``: the
    eval and train window-attention kernels B1, B2f and B2b; ``knn``: the
    1-NN search and combine, B3), then gather, index_add (scatter), sort,
    gemm, reduce, copy, elementwise, memset, collective (NCCL) and other;
  * the top operations by device time, with their counts;
  * by module: each event goes to the innermost range around its launch,
    the ``record_function`` ranges that ``module_ranges`` and ``annotate``
    open around the model's submodules and the structure functions, and in
    the backward the autograd node that launched it
    (``autograd::engine::evaluate_function: <node>``).

Also here, used by ``chip_smoke.py`` as well: ``trace`` (one run under the
profiler), ``busy_ms``, ``range_kernels``, ``named_kernels``, ``top_kernels``
and ``kernel_name``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from unittest import mock

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATEGORIES = ('cuda_runtime', 'cuda_driver')
BACKWARD_NODE = 'autograd::engine::evaluate_function: '
STEP_RANGE = 'profile_step#'

# (bucket, lower-case substrings of a kernel or operator name), first match
# wins: the port's kernels first, then the library's by what they compute
BUCKETS = (
    ('attention', ('window_attention_',)),
    ('knn', ('nearest_point',)),
    ('collective', ('nccl',)),
    ('sort', ('sort', 'radix')),
    ('gemm', ('gemm', 'xmma', 'nvjet', 'cutlass', 'aten::mm', 'aten::addmm', 'aten::bmm')),
    ('index_add', ('indexfunc', 'index_add', 'scatter', 'index_put')),
    ('gather', ('gather', 'index_select', 'indexselect', 'aten::index', 'aten::take')),
    ('reduce', ('reduce', 'scan', 'softmax', 'layer_norm', 'batch_norm', 'aten::sum',
                'aten::max', 'aten::min', 'aten::amax', 'aten::mean', 'cumsum', 'cummax')),
    ('copy', ('copy', 'catarray', 'aten::cat')),
    ('elementwise', ('elementwise',)),
)


def kernel_name(mangled: str) -> str:
    """'name<template ints>' of a mangled kernel whose name ends in _kernel:
    an Itanium-mangled identifier is its length in digits, then the name."""
    for run in re.finditer(r'\d+', mangled):
        for start in range(run.start(), run.end()):
            end = run.end() + int(mangled[start:run.end()])
            ident = mangled[run.end():end]
            if ident.endswith('_kernel'):
                args = re.match(r'I((?:Li\d+E)+)E', mangled[end:])
                return f'{ident}<{", ".join(re.findall(r"Li(\d+)E", args.group(1)))}>' \
                    if args else ident
    return mangled


def trace(fn, device: str = 'cuda', path: str | None = None):
    """Run fn() once under torch.profiler. Returns (chrome trace events, wall
    ms of the run: CUDA events on the card, the host clock with device
    'cpu', where only the host is traced). With `path`, the chrome trace is
    kept there."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = device != 'cpu'
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
            else:
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
        out = path or os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(out)
        events = load_trace(out)
    return events, start.elapsed_time(end) if on_card else (t1 - t0) * 1e3


def load_trace(path: str) -> list:
    """The events of a chrome trace that torch.profiler exported."""
    with open(path) as f:
        return json.load(f)['traceEvents']


def busy_ms(events) -> float:
    """Milliseconds during which at least one kernel, copy or memset ran."""
    spans = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                   if e.get('cat') in DEVICE_CATEGORIES)
    total, lo, hi = 0.0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def range_kernels(events, name):
    """(number of record_function ranges called name, device ms and count
    of the kernels launched inside them, matched by correlation id)."""
    ranges = [(e['ts'], e['ts'] + e['dur']) for e in events
              if e.get('cat') == 'user_annotation' and e.get('name') == name]
    launched = {e.get('args', {}).get('correlation') for e in events
                if e.get('cat') in LAUNCH_CATEGORIES
                and any(lo <= e['ts'] <= hi for lo, hi in ranges)}
    durs = [e['dur'] for e in events if e.get('cat') == 'kernel'
            and e.get('args', {}).get('correlation') in launched - {None}]
    return len(ranges), sum(durs) / 1e3, len(durs)


def named_kernels(events, *names):
    """(device ms, count) of the kernels whose name contains every one of
    `names`."""
    durs = [e['dur'] for e in events
            if e.get('cat') == 'kernel' and all(n in e['name'] for n in names)]
    return sum(durs) / 1e3, len(durs)


def top_kernels(events, k=12):
    """The k kernel names with the most device time: [(name, ms, count)]."""
    by_name = {}
    for e in events:
        if e.get('cat') == 'kernel':
            ms, n = by_name.get(e['name'], (0.0, 0))
            by_name[e['name']] = (ms + e['dur'] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:k]
    return [(name[:90], round(ms, 3), n) for name, (ms, n) in top]


def bucket(name: str, category: str = 'kernel') -> str:
    """The bucket of a device event (or, in a CPU trace, a leaf operator)."""
    if category == 'gpu_memcpy':
        return 'copy'
    if category == 'gpu_memset':
        return 'memset'
    low = name.lower()
    for key, parts in BUCKETS:
        if any(p in low for p in parts):
            return key
    return 'other'


def _leaf_ops(events):
    """The cpu_op events with no cpu_op nested inside them on their thread."""
    ops = sorted((e for e in events if e.get('cat') == 'cpu_op'),
                 key=lambda e: (e['tid'], e['ts'], -e['dur']))
    leaves = []
    for i, e in enumerate(ops):
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        if nxt is None or nxt['tid'] != e['tid'] or nxt['ts'] >= e['ts'] + e['dur']:
            leaves.append(e)
    return leaves


def device_events(events, cpu: bool = False):
    """[(name, category, device us, (thread, host ts) of its launch or None)]:
    the kernels, copies and memsets of a trace of the card, or with `cpu` the
    leaf operators of a trace of the CPU (each its own launch)."""
    if cpu:
        return [(e['name'], 'cpu_op', e['dur'], (e['tid'], e['ts'])) for e in _leaf_ops(events)]
    launches = {e['args']['correlation']: (e['tid'], e['ts']) for e in events
                if e.get('cat') in LAUNCH_CATEGORIES and 'correlation' in e.get('args', {})}
    return [(e['name'], e['cat'], e['dur'], launches.get(e.get('args', {}).get('correlation')))
            for e in events if e.get('cat') in DEVICE_CATEGORIES]


def _ranges(events):
    """(thread, start, end, name) of every record_function range and every
    autograd node that ran in the backward."""
    out = []
    for e in events:
        name = e.get('name', '')
        if e.get('cat') == 'user_annotation' or (e.get('cat') == 'cpu_op'
                                                 and name.startswith(BACKWARD_NODE)):
            if name.startswith(BACKWARD_NODE):
                name = 'backward: ' + name[len(BACKWARD_NODE):]
            out.append((e['tid'], e['ts'], e['ts'] + e['dur'], name))
    return out


def _innermost_ranges(ranges, points):
    """For each (thread, ts) point, the name of the innermost range of
    `ranges` ((thread, start, end, name), nested per thread) holding it, or
    None; a point None stays None. One sweep over the sorted marks."""
    marks = []
    for i, (tid, start, end, _) in enumerate(ranges):
        marks.append((tid, start, 0, start - end, i))    # at one start, the outer opens first
        marks.append((tid, end, 2, 0, i))
    for j, p in enumerate(points):
        if p is not None:
            marks.append((p[0], p[1], 1, 0, j))
    marks.sort(key=lambda m: (str(m[0]), m[1], m[2], m[3]))
    out = [None] * len(points)
    stack, tid = [], None
    for t, _, kind, _, i in marks:
        if t != tid:
            stack, tid = [], t
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            if i in stack:
                stack.remove(i)
        elif stack:
            out[i] = ranges[stack[-1]][3]
    return out


def analyze(events, steps: int | None = None, top: int = 30, cpu: bool = False) -> dict:
    """Device ms per step of a trace: in all, by bucket, the top `top`
    operations (ms and launches per step) and by module (innermost range of
    the launch; '(no range)' outside every one). The steps are the
    ``profile_step#i`` ranges of the trace, or `steps` where it has none."""
    dev = device_events(events, cpu)
    ranges = _ranges(events)
    n_steps = sum(1 for r in ranges if r[3].startswith(STEP_RANGE)) or steps or 1
    owners = _innermost_ranges(ranges, [d[3] for d in dev])
    total = 0.0
    by_bucket, by_op, by_module = defaultdict(float), defaultdict(float), defaultdict(float)
    counts = defaultdict(int)
    for (name, cat, dur, _), owner in zip(dev, owners):
        ms = dur / 1e3
        total += ms
        by_bucket[bucket(name, cat)] += ms
        by_op[name] += ms
        counts[name] += 1
        if owner is None or owner.startswith(STEP_RANGE):
            owner = '(no range)'
        by_module[owner] += ms

    def per_step(d):
        return {k: v / n_steps for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        'steps': n_steps,
        'device': 'cpu' if cpu else 'cuda',
        'device_ms_per_step': total / n_steps,
        'busy_ms_per_step': None if cpu else busy_ms(events) / n_steps,
        'by_bucket': per_step(by_bucket),
        'top': [[name, ms / n_steps, counts[name] / n_steps] for name, ms in top_ops],
        'by_module': per_step(by_module),
    }


def report(result: dict, top: int = 30, modules: int = 40) -> None:
    """Print analyze's result as tools/profile.py prints its own."""
    what = 'leaf CPU operator' if result['device'] == 'cpu' else 'device'
    busy = result['busy_ms_per_step']
    print(f'total {what} ms: {result["device_ms_per_step"]:.3f} a step over '
          f'{result["steps"]} steps' + ('' if busy is None else f' (device busy {busy:.3f})'))
    print('== by bucket (ms a step) ==')
    for k, v in result['by_bucket'].items():
        print(f'  {k:22s} {v:10.3f}')
    print(f'== top {top} ops (ms and launches a step) ==')
    for name, ms, n in result['top'][:top]:
        print(f'  {ms:9.3f} ms x{n:7.1f}  {name[:110]}')
    print('== by module (ms a step, innermost range of the launch) ==')
    for k, v in itertools.islice(result['by_module'].items(), modules):
        print(f'  {v:9.3f}  {k[:100]}')


@contextlib.contextmanager
def module_ranges(model, depth: int = 2):
    """While open, the forward of `model` (named by its class) and of each
    named submodule down to `depth` levels ('PointTransformer_0.
    SWFormerBlock_1') runs inside a record_function range of its name. The
    hooks open and close ranges only: the outputs are bit-equal."""
    from torch.profiler import record_function
    handles, open_ranges = [], defaultdict(list)

    def hook(name):
        def pre(module, args):
            rf = record_function(name)
            rf.__enter__()
            open_ranges[id(module)].append(rf)

        def post(module, args, output):
            open_ranges[id(module)].pop().__exit__(None, None, None)
        return pre, post

    try:
        for name, mod in model.named_modules():
            if name.count('.') >= depth:
                continue
            pre, post = hook(name or type(model).__name__)
            handles.append(mod.register_forward_pre_hook(pre))
            handles.append(mod.register_forward_hook(post, always_call=True))
        yield model
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def annotate(owner, attr: str, name):
    """While open, owner.attr (a function) runs inside a record_function
    range: `name`, or name(i) for its i-th call from 0. Its results are its
    own."""
    from torch.profiler import record_function
    fn = getattr(owner, attr)
    calls = itertools.count()

    def wrapped(*args, **kwargs):
        with record_function(name(next(calls)) if callable(name) else name):
            return fn(*args, **kwargs)

    with mock.patch.object(owner, attr, wrapped):
        yield

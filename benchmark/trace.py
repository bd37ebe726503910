"""Reading a ``torch.profiler`` chrome trace: device busy time, the device
time of the kernels launched inside the benchmark's ranges, the top device
operations and the idle gaps by what the host was doing.

``busy_ms``, ``device_events``, ``ranges`` and ``innermost`` are frozen
copies of the port's ``utils/profiling`` (``busy_ms``, ``device_events``,
``_ranges``, ``_innermost_ranges``), ``kernel_name`` of its mangled-name
reader. The device events of a trace of the card are the kernels, copies
and memsets; each is tied by its correlation id to the runtime call on the
host that launched it, and so to the innermost ``record_function`` range
(or, in the backward, autograd node) open around that call.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATEGORIES = ('cuda_runtime', 'cuda_driver')
BACKWARD_NODE = 'autograd::engine::evaluate_function: '
PHASE_PREFIX = 'bench.'


def kernel_name(mangled: str) -> str:
    """'name<template ints>' of a mangled kernel whose name ends in _kernel,
    else the name as given."""
    for run in re.finditer(r'\d+', mangled):
        for start in range(run.start(), run.end()):
            end = run.end() + int(mangled[start:run.end()])
            ident = mangled[run.end():end]
            if ident.endswith('_kernel'):
                args = re.match(r'I((?:Li\d+E)+)E', mangled[end:])
                return f'{ident}<{", ".join(re.findall(r"Li(\d+)E", args.group(1)))}>' \
                    if args else ident
    return mangled


def busy_intervals(events) -> list:
    """The merged [start, end] µs intervals in which a device event ran."""
    spans = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                   if e.get('cat') in DEVICE_CATEGORIES)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_ms(events) -> float:
    return sum(e - s for s, e in busy_intervals(events)) / 1e3


def device_events(events) -> list:
    """[(name, category, µs, (thread, host ts) of its launch or None)]."""
    launches = {e['args']['correlation']: (e['tid'], e['ts']) for e in events
                if e.get('cat') in LAUNCH_CATEGORIES and 'correlation' in e.get('args', {})}
    return [(e['name'], e['cat'], e['dur'], launches.get(e.get('args', {}).get('correlation')))
            for e in events if e.get('cat') in DEVICE_CATEGORIES]


def ranges(events) -> list:
    """(thread, start, end, name) of every record_function range and every
    autograd node of the backward ('backward: <node>')."""
    out = []
    for e in events:
        name = e.get('name', '')
        if e.get('cat') == 'user_annotation' or (e.get('cat') == 'cpu_op'
                                                 and name.startswith(BACKWARD_NODE)):
            if name.startswith(BACKWARD_NODE):
                name = 'backward: ' + name[len(BACKWARD_NODE):]
            out.append((e['tid'], e['ts'], e['ts'] + e['dur'], name))
    return out


def innermost(rngs, points) -> list:
    """For each (thread, ts) point (or None), the name of the innermost of
    `rngs` ((thread, start, end, name), nested per thread) that holds it, or
    None."""
    marks = []
    for i, (tid, start, end, _) in enumerate(rngs):
        marks.append((tid, start, 0, start - end, i))
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
            out[i] = rngs[stack[-1]][3]
    return out


def device_ms_by_owner(events) -> dict:
    """{innermost range name or '(no range)': device ms}."""
    dev = device_events(events)
    owners = innermost(ranges(events), [d[3] for d in dev])
    out = defaultdict(float)
    for (_, _, dur, _), owner in zip(dev, owners):
        out[owner or '(no range)'] += dur / 1e3
    return dict(out)


def top_ops(events, k: int = 10) -> list:
    """[[kernel name, seconds]] of the k device operations with the most
    time."""
    by = defaultdict(float)
    for name, cat, dur, _ in device_events(events):
        by[kernel_name(name) if cat == 'kernel' else name] += dur / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(events, lo: float, hi: float, k: int = 10) -> list:
    """[[phase, seconds]]: the device's idle time in [lo, hi] µs, each gap
    put to the benchmark phase range ('bench.*', innermost) open on the host
    when it began, summed by phase, the k largest."""
    busy = [iv for iv in busy_intervals(events) if iv[1] > lo and iv[0] < hi]
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    rngs = [r for r in ranges(events) if r[3].startswith(PHASE_PREFIX)]
    tid = rngs[0][0] if rngs else None
    labels = innermost(rngs, [(tid, s) for s, _ in gaps])
    by = defaultdict(float)
    for (s, e), label in zip(gaps, labels):
        by[label[len(PHASE_PREFIX):] if label else '(no phase)'] += (e - s) / 1e6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


class Profiler:
    """torch.profiler over a stretch of the window, with the time from
    start() to stop() on the device's clock (CUDA events) and on the
    trace's."""

    def __init__(self, device):
        self.device = device
        self.events, self.window_ms = None, None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        on_card = self.device.type == 'cuda'
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if on_card:
            torch.cuda.synchronize(self.device)
            self._ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._ev[0].record()
        self._t0 = time.perf_counter()

    def stop(self):
        import torch
        if self.device.type == 'cuda':
            self._ev[1].record()
            self._ev[1].synchronize()
            self.window_ms = self._ev[0].elapsed_time(self._ev[1])
        else:
            self.window_ms = (time.perf_counter() - self._t0) * 1e3
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)['traceEvents']
        finally:
            os.remove(path)
        del self._prof
        torch.cuda.synchronize(self.device) if self.device.type == 'cuda' else None

    def span_us(self) -> tuple:
        """(first, last) µs of the trace's device events, or of its ranges
        on the CPU."""
        dev = [(e['ts'], e['ts'] + e['dur']) for e in self.events
               if e.get('cat') in DEVICE_CATEGORIES]
        if not dev:
            dev = [(r[1], r[2]) for r in ranges(self.events)] or [(0.0, 0.0)]
        return min(s for s, _ in dev), max(e for _, e in dev)

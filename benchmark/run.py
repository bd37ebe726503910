"""Runs one cell of the benchmark once and prints its result as one JSON line.

    python benchmark/run.py --workload segformer.train --seed 7 --seconds 51 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. Everything else is found by name: the configuration's file
(``configs/<config>.json``, the program's configuration as run), the mix
(``traffic/<mix>.json``), the loop the mix names (``loops/<loop>.py``), the
limits of the comparison that decides ``correct`` (``limits/<config>.<loop>
.json``) and, in a ``--trace 1`` run, one reader a per-layer metric
(``metrics/<metric>.py``). A new configuration, mix, loop or metric is new
files and new entries in ``BENCHMARK.json``: no file here changes.

A run: set-up (the program's kernels built into its own build directory, the
weights and frames made from ``--seed``, every shape warmed), the window of
``--seconds``, the peak memory read, the program's state freed, the plain
reference's comparison, then the line. With ``--trace 1`` a few steps or
frames inside the window run under ``torch.profiler`` and the line carries
the per-layer metrics, ``busy_s``/``window_s`` and a ``breakdown`` instead
of the end-to-end metrics. The run needs the cards its cell asks for and
exits with an error without them; it never falls back to the CPU.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'openseg3d_tpu')


def load_module(path: Path, name: str):
    """The module in a file found by name."""
    if not path.is_file():
        raise FileNotFoundError(f'no {path}')
    spec = importlib.util.spec_from_file_location(f'benchmark_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """One cell of a benchmark spec and the files its names lead to."""

    def __init__(self, spec: dict, name: str, bench_dir: Path):
        self.spec = spec
        cells = {w['name']: w for w in spec['workloads']}
        if name not in cells:
            raise KeyError(f'no workload {name!r}: {sorted(cells)}')
        self.workload = cells[name]
        self.name = name
        config = {c['name']: c for c in spec['configs']}[self.workload['config']]
        self.config = json.loads((bench_dir.parent / config['file']).read_text())['config']
        self.traffic = json.loads(
            (bench_dir / 'traffic' / f'{self.workload["traffic"]}.json').read_text())
        self.loop_name = self.traffic['loop']
        self.loop = load_module(bench_dir / 'loops' / f'{self.loop_name}.py', self.loop_name)
        limits = bench_dir / 'limits' / f'{self.workload["config"]}.{self.loop_name}.json'
        self.limits = json.loads(limits.read_text())['limits']

    def metrics(self, section: str) -> list:
        """The cell's metrics of `section`: the end-to-end ones that list it
        or list no cells, and the per-layer ones that list it (each names
        its cells)."""
        if section == 'end_to_end':
            return [m for m in self.spec['end_to_end']
                    if self.name in m.get('workloads', [self.name])]
        return [m for m in self.spec['per_layer'] if self.name in m['workloads']]


class Run:
    """What a loop is given: the cell, the seed, the device, the trace
    flag, and the program's config."""

    def __init__(self, cell: Cell, seed: int, device, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits

    def program_config(self):
        from openseg3d_tpu_torch.config import cfg_from_file
        cfg = cfg_from_file(None, overrides=self.config)
        if json.loads(json.dumps(cfg)) != self.config:
            raise ValueError('the program resolves the configuration file differently')
        return cfg


def set_cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the program builds
    its own into openseg3d_tpu_torch/_build)."""
    cache = root / '.bench_cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['USE_FLAX'] = '0'


def card(device) -> dict:
    import torch
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': 1,
            'memory_peak_bytes': int(torch.cuda.max_memory_reserved(device))}


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             bench_dir: Path = HERE, require_chip: bool = True) -> dict:
    """One run of a cell; returns the result line as a dict. Without
    `require_chip` (tests) a run without a card goes on, on the CPU."""
    import torch
    cell = Cell(spec, name, bench_dir)
    chips = int(cell.workload['chips'])
    on_card = torch.cuda.is_available() and torch.cuda.device_count() >= chips
    if require_chip and not on_card:
        raise SystemExit(f'{name} needs {chips} CUDA card(s); found '
                         f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
    device = torch.device('cuda', 0) if on_card else torch.device('cpu')
    run = Run(cell, seed, device, trace)
    loop = cell.loop
    session = loop.setup(run, PROCESS_START)
    profiler = None
    if trace:
        from benchmark.trace import Profiler
        profiler = Profiler(device)
    measured = loop.window(session, seconds, profiler)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        measured['peak_mem_gib'] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    dev = card(device)
    loop.release(session)
    checked = loop.check(session)
    result = {'correct': bool(checked['correct']), 'attempted': int(measured['attempted']),
              'failed': int(measured['failed']) + int(checked.get('failed', 0))}
    wanted = cell.metrics('per_layer' if trace else 'end_to_end')
    metrics = {}
    if trace:
        from benchmark.trace import busy_ms, idle_gaps, top_ops
        ctx = loop.layer_context(session, profiler, checked)
        for m in wanted:
            value = load_module(bench_dir / 'metrics' / f'{m["name"]}.py', m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        lo, hi = profiler.span_us()
        dev['busy_s'] = busy_ms(profiler.events) / 1e3
        dev['window_s'] = profiler.window_ms / 1e3
        result['breakdown'] = {'device_ops': top_ops(profiler.events),
                               'idle_gaps': idle_gaps(profiler.events, lo, hi)}
    else:
        for m in wanted:
            if m['name'] not in measured:
                if device.type == 'cuda':
                    raise KeyError(f'loop {cell.loop_name} measures no {m["name"]}')
                continue        # a device reading that a CPU run has not
            metrics[m['name']] = {'value': measured[m['name']], 'unit': m['unit']}
    result['metrics'] = metrics
    result['device'] = dev
    result['numbers'] = checked['numbers']
    result['compared'] = checked['compared']
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='Run one benchmark cell once; one JSON line')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = HERE.parent
    sys.path.insert(0, str(root))
    set_cache_dirs(root)
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f'loaded in this process: {", ".join(found)}', file=sys.stderr)
        return 3
    for c in result['compared']:
        print(f'{c["name"]} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""What the readers of the program's own spans share.

The program opens a ``record_function`` range named ``seg3d.<name>`` at
each of its layer boundaries while a profiler records (``seg3d.<name>#<arg>``
where the span carries a step or call number, cut off here). A span owns
what was launched inside it, at any depth, on its own thread: the enclosing
span, not the innermost range, so the benchmark's own ranges nested inside
do not matter. Backward work is owned by its autograd node ('backward:
<node>', on the autograd thread). Each value is per traced unit (a step or
a frame), and None off the card or where the trace holds no span of the
program (a program without them).
"""

from __future__ import annotations

from benchmark import trace
from benchmark.metrics._share import on_card

PREFIX = 'seg3d.'
NODE = 'backward: '
# runtime calls that block the host until the device is done
SYNCS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize', 'cudaEventSynchronize', 'cudaMemcpy')
STREAM_SYNC = 'cudaStreamSynchronize'
ASYNC_COPY = 'cudaMemcpyAsync'
PAGEABLE = 'Pageable'
LAUNCHES = ('cudaLaunch', 'cuLaunch')


def program_ranges(events, names=None) -> list:
    """(thread, start, end, name) of the program's spans ('#<arg>' cut) and
    of the autograd nodes; with `names`, those named in it."""
    out = []
    for tid, start, end, name in trace.ranges(events):
        if name.startswith(PREFIX):
            name = name.split('#', 1)[0]
        elif not name.startswith(NODE):
            continue
        if names is None or name in names:
            out.append((tid, start, end, name))
    return out


def _spans_found(ctx, rngs) -> bool:
    return on_card(ctx) and any(r[3].startswith(PREFIX) for r in rngs)


def device_ms(ctx, names):
    """Device ms a unit of the kernels, copies and memsets launched inside a
    span or node named in `names`."""
    rngs = program_ranges(ctx['events'], names)
    if not _spans_found(ctx, rngs):
        return None
    dev = trace.device_events(ctx['events'])
    owners = trace.innermost(rngs, [d[3] for d in dev])
    return sum(d[2] for d, owner in zip(dev, owners) if owner) / 1e3 / ctx['units']


def host_ms(ctx, name: str):
    """Host ms a unit inside the spans called `name` (never nested in one
    another)."""
    rngs = program_ranges(ctx['events'], {name})
    if not _spans_found(ctx, rngs):
        return None
    return sum(end - start for _, start, end, _ in rngs) / 1e3 / ctx['units']


def _calls(events) -> list:
    """[(thread, ts, name, correlation)] of the CUDA API calls (``cuda*`` and
    ``cu*``), in time order on each thread."""
    calls = [(e['tid'], e['ts'], e['name'], e.get('args', {}).get('correlation'))
             for e in events if e.get('cat') in trace.LAUNCH_CATEGORIES]
    return sorted(calls, key=lambda c: (str(c[0]), c[1]))


def _program_calls(ctx):
    """[(call, counted)]: every CUDA API call, and whether it lies
    inside a program span or an autograd node; None where no span is."""
    rngs = program_ranges(ctx['events'])
    if not _spans_found(ctx, rngs):
        return None
    calls = _calls(ctx['events'])
    owners = trace.innermost(rngs, [(c[0], c[1]) for c in calls])
    return [(c, owner is not None) for c, owner in zip(calls, owners)]


def sync_calls(ctx):
    """[(call, counted)] of the calls that block the host, each sync once:
    the sync calls, and a ``cudaMemcpyAsync`` to or from pageable memory
    (the runtime syncs the stream first). A ``cudaStreamSynchronize`` right
    after a pageable copy on its thread (torch's ``memcpy_and_sync``:
    ``.item()``, ``.cpu()``, a blocking ``.to(device)``) is the same sync."""
    calls = _program_calls(ctx)
    if calls is None:
        return None
    copies = {e.get('args', {}).get('correlation'): e['name'] for e in ctx['events']
              if e.get('cat') == 'gpu_memcpy'}
    out, after_pageable = [], None
    for call, counted in calls:
        tid, _, name, corr = call
        pageable = name == ASYNC_COPY and PAGEABLE in copies.get(corr, '')
        if pageable or (name in SYNCS and not (name == STREAM_SYNC and after_pageable == tid)):
            out.append((call, counted))
        after_pageable = tid if pageable else None
    return out


def host_syncs(ctx):
    """Host-blocking calls a unit inside the program's spans and nodes."""
    syncs = sync_calls(ctx)
    return None if syncs is None else sum(c for _, c in syncs) / ctx['units']


def launches(ctx):
    """Kernel launches a unit inside the program's spans and nodes, one a
    correlation id."""
    calls = _program_calls(ctx)
    if calls is None:
        return None
    ids = {call[3] for call, counted in calls if counted and call[2].startswith(LAUNCHES)}
    return len(ids) / ctx['units']

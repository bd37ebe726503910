"""What the readers share: the idle share, the whole step's share of the
peak, and a layer's share of its roofline."""

from __future__ import annotations

from benchmark import counts, spans, trace

LAYER_RANGES = {'attention': (spans.ATTENTION, spans.ATTENTION_BACKWARD),
                'conv': (spans.SPARSE_CONV, spans.SPARSE_CONV_BACKWARD)}


def on_card(ctx) -> bool:
    return ctx['device'].type == 'cuda' and bool(ctx['window_ms'])


def idle_share(ctx):
    """% of the traced stretch in which no device operation ran."""
    if not on_card(ctx):
        return None
    busy = trace.busy_ms(ctx['events'])
    return None if busy <= 0 else 100.0 * (1.0 - busy / ctx['window_ms'])


def mfu(ctx, passes: int):
    """% of the bf16 peak: `passes` forwards' FLOPs a unit (3 for a train
    step: the forward and a backward of twice its work) over a unit's
    time."""
    if not on_card(ctx) or not ctx['records']:
        return None
    flops = passes * counts.forward_flops(ctx['records']) / ctx['records_units']
    seconds = ctx['window_ms'] / ctx['units'] / 1e3
    return 100.0 * flops / seconds / counts.BF16_FLOPS_PER_S


def roofline(ctx, layer: str):
    """% of its least time that the layer's device time reaches: the
    kernels launched in the benchmark's range around the layer and in its
    backward node."""
    if not on_card(ctx) or not ctx['records']:
        return None
    owners = trace.device_ms_by_owner(ctx['events'])
    ms = sum(owners.get(name, 0.0) for name in LAYER_RANGES[layer])
    least = (counts.layer_least_ms(ctx['records'], layer, ctx['train'])
             / ctx['records_units'] * ctx['units'])
    return None if ms <= 0 or least <= 0 else 100.0 * least / ms

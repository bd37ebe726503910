"""The sparse convs' share of their roofline (live rulebook pairs)."""
from benchmark.metrics._share import roofline


def read(ctx):
    return roofline(ctx, 'conv')

"""Window attention's share of its roofline (live windows and tokens)."""
from benchmark.metrics._share import roofline


def read(ctx):
    return roofline(ctx, 'attention')

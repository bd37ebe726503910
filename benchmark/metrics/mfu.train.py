"""The whole train step's share of the card's bf16 peak."""
from benchmark.metrics._share import mfu


def read(ctx):
    return mfu(ctx, 3)

"""The whole forward's share of the card's bf16 peak, a frame."""
from benchmark.metrics._share import mfu


def read(ctx):
    return mfu(ctx, 1)

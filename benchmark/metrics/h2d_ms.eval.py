"""Host ms a frame in the copy of the padded batch to the card
(``seg3d.h2d``)."""
from benchmark.metrics._program import host_ms


def read(ctx):
    return host_ms(ctx, 'seg3d.h2d')

"""Device ms a unit launched inside the structure build (``seg3d.structure``:
the rulebooks and, in Segformer, the window partitions)."""
from benchmark.metrics._program import device_ms


def read(ctx):
    return device_ms(ctx, {'seg3d.structure'})

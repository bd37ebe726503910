"""Device ms a frame of the window permutes (``seg3d.window_permute``)."""
from benchmark.metrics._program import device_ms


def read(ctx):
    return device_ms(ctx, {'seg3d.window_permute'})

"""Device ms a step of the window permutes: launched inside
``seg3d.window_permute`` and by their backward node."""
from benchmark.metrics._program import device_ms


def read(ctx):
    return device_ms(ctx, {'seg3d.window_permute', 'backward: _PermuteRowsBackward'})

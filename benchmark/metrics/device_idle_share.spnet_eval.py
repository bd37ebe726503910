"""% of the traced stretch in which the device ran nothing: the reading of
``device_idle_share.eval``, in the cell whose speed is read per layer."""
from benchmark.metrics._share import idle_share


def read(ctx):
    return idle_share(ctx)

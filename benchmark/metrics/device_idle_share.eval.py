"""% of the traced stretch in which the device ran nothing."""
from benchmark.metrics._share import idle_share


def read(ctx):
    return idle_share(ctx)

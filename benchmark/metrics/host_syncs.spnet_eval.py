"""Host-blocking CUDA calls a unit inside the program's spans and autograd
nodes: the reading of ``host_syncs.eval``, in the cell whose speed is read
per layer."""
from benchmark.metrics._program import host_syncs


def read(ctx):
    return host_syncs(ctx)

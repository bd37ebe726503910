"""Host-blocking CUDA calls a unit inside the program's spans and autograd
nodes: syncs, blocking copies, pageable copies (one with torch's sync after
it)."""
from benchmark.metrics._program import host_syncs


def read(ctx):
    return host_syncs(ctx)

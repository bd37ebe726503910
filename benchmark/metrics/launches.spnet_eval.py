"""Kernel launches (``cudaLaunch*``/``cuLaunch*``) a unit inside the
program's spans and autograd nodes: the reading of ``launches.eval``, in
the cell whose speed is read per layer."""
from benchmark.metrics._program import launches


def read(ctx):
    return launches(ctx)

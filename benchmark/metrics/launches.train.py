"""Kernel launches (``cudaLaunch*``/``cuLaunch*``) a unit inside the
program's spans and autograd nodes."""
from benchmark.metrics._program import launches


def read(ctx):
    return launches(ctx)

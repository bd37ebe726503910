"""openseg3d_tpu_torch — the PyTorch/CUDA port of openseg3d_tpu.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``core/``, ``data/``, ``engine.py``) so that every module has an obvious
counterpart, and it is held against that package by ``tests/test_torch_*.py``.
It keeps the JAX package's padded static-capacity layout (``[B, V, C]`` with
validity masks) and its ``RUNTIME`` capacities, so outputs compare row by row.

The port imports ``torch`` and numpy and never JAX, flax or optax: the machine
that runs it on a GPU has none of them, and it imports nothing of the JAX
package either. The pieces of that package it needs on the host have copies
here, held equal to their originals by ``tests/test_torch_host.py``:
``config`` (PyYAML only to read a file), ``data.batch`` and
``core.voxelizer`` (numpy, and ``native``: the C++ voxelizer, built with g++
at first use).

Every Pallas kernel of the JAX package on the ported path has a hand-written
CUDA counterpart under ``csrc/``; the wrapper launches it for CUDA tensors and
runs its plain PyTorch version for CPU tensors.
"""

__version__ = '0.1.0'

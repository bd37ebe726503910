"""RNG control.

Counterpart of ``openseg3d_tpu/utils/random.py``: the seed is the
caller's, or drawn from numpy on rank 0 and broadcast to every rank of the
process group, so that every rank draws the same weights. ``set_random_seed``
seeds Python's ``random``, numpy's global generator and torch's; the train
step's dropout does not read them, it draws from a generator seeded per step.
"""

from __future__ import annotations

import random as _pyrandom

import numpy as np
import torch

from ..parallel.dist import broadcast_int, world


def init_random_seed(seed: int | None = None) -> int:
    """The given seed, or a fresh one from numpy's global generator on rank
    0, the same on every rank."""
    if seed is not None:
        return int(seed)
    seed = int(np.random.randint(2 ** 31))
    return broadcast_int(seed) if world() > 1 else seed


def set_random_seed(seed: int) -> None:
    """Seed every host-side RNG and torch's default generators."""
    _pyrandom.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)

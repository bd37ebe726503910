"""RNG control.

Counterpart of ``openseg3d_tpu/utils/random.py`` for one process: the seed
is the caller's, or drawn from numpy. The broadcast of a drawn seed to every
process waits for the multi-GPU slice (ROADMAP A10). ``set_random_seed``
seeds Python's ``random``, numpy's global generator and torch's; the train
step's dropout does not read them, it draws from a generator seeded per step.
"""

from __future__ import annotations

import random as _pyrandom

import numpy as np
import torch


def init_random_seed(seed: int | None = None) -> int:
    """The given seed, or a fresh one from numpy's global generator."""
    if seed is not None:
        return int(seed)
    return int(np.random.randint(2 ** 31))


def set_random_seed(seed: int) -> None:
    """Seed every host-side RNG and torch's default generators."""
    _pyrandom.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)

"""Process-aware logging.

Counterpart of ``openseg3d_tpu/utils/logging.py`` with the process index
taken from ``torch.distributed`` (rank 0 when no process group is set up)
instead of JAX: process 0 logs at INFO, every other process at ERROR only.
A log file is attached for the length of one run (``log_to_file``), not for
the life of the cached logger, so that the command-line tools, called in one
process one after another, each write their own log.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch.distributed as dist

_FORMAT = '%(asctime)s - %(name)s - %(levelname)s - %(message)s'
_initialized: dict[str, logging.Logger] = {}


def _process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_logger(name: str = 'openseg3d_tpu_torch',
               log_level: int = logging.INFO) -> logging.Logger:
    if name in _initialized:
        return _initialized[name]

    logger = logging.getLogger(name)
    logger.propagate = False
    stream = logging.StreamHandler()
    stream.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(stream)
    logger.setLevel(log_level if _process_index() == 0 else logging.ERROR)
    _initialized[name] = logger
    return logger


def get_root_logger(log_level: int = logging.INFO) -> logging.Logger:
    return get_logger('openseg3d_tpu_torch', log_level)


@contextlib.contextmanager
def log_to_file(logger: logging.Logger, log_file: str):
    """Also write `logger`'s records to `log_file` (appended) inside the
    block; the file is closed when the block ends."""
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    fh = logging.FileHandler(log_file, 'a')
    fh.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(fh)
    try:
        yield logger
    finally:
        logger.removeHandler(fh)
        fh.close()

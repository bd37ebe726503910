"""Wall-clock timing helpers: a copy of ``openseg3d_tpu/utils/timer.py``,
used by the train loop for its step and data-wait times."""

from __future__ import annotations

import time


class Timer:
    """Context-manager stopwatch with accumulation."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._total = 0.0
        self._count = 0
        self._start = None

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._total += time.perf_counter() - self._start
        self._count += 1
        self._start = None

    @property
    def total(self) -> float:
        return self._total

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._total / max(self._count, 1)

"""Tests of the benchmark: `python -m pytest benchmark/tests -q`. The ones
marked `cuda` need a card and skip without one (the choice is made inside
each test)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: runs on an NVIDIA GPU; skips without one')

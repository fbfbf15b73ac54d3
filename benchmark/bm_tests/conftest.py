"""The benchmark's own tests: ``python -m pytest benchmark/bm_tests -q``.

Tests marked ``card`` need an NVIDIA card; each decides inside itself and
skips without one."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, BENCH, os.path.dirname(BENCH)) if p not in sys.path]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")

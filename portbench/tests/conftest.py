"""Test configuration of the benchmark's own tests (``portbench/tests``),
which run apart from the repo's ``tests/`` and never import JAX:

    python -m pytest portbench/tests -q

Tests that need a CUDA card carry the ``cuda`` marker and decide inside
the test whether there is one."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")

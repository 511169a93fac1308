"""Settings of the benchmark's own tests (``python -m pytest t4bench/tests``
from the repository's root)."""

import os
import sys

import pytest

# The checks of t4bench_common assert as a test does.
pytest.register_assert_rewrite("t4bench_common")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")

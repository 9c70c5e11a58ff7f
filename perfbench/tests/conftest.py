"""Tests of the benchmark's harness. Run from the repo root:

    python -m pytest perfbench/tests -q

The tests marked ``card`` run a cell on an NVIDIA card and skip without
one; the others run on the CPU at a tiny size.
"""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"users": 3000, "items": 1500}
TINY_PARAMS = {"ml32m-raw-int8.full-build": {}, "ml32m-raw-int8.refresh-8k": {"targets": 300},
               "ml32m-bm25-f32.score-8k": {"batch": 500}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs on an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs a cell on the card")

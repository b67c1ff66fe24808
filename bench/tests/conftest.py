"""Shared set-up of the benchmark's tests: ``bench/`` importable and one
PyTorch thread a process; helpers in ``bench_testing.py``."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH, BENCH / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

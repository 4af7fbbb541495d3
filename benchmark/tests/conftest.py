"""Fixtures of the benchmark's CPU tests (``tiny.py`` holds the tiny
cells)."""
from __future__ import annotations

import pytest
import torch

from tiny import make_root


@pytest.fixture
def tiny_root(tmp_path):
    """A root holding ``BENCHMARK.json`` with the repository's entries plus
    the tiny cells and a test-only metric, and a copy of ``benchmark/``
    plus their files."""
    return make_root(tmp_path)


@pytest.fixture
def cpu():
    torch.manual_seed(0)
    return torch.device("cpu")

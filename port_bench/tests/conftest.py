"""Fixtures of the benchmark's tests and the ``card`` marker."""

from pathlib import Path

import pytest

from tiny import make_tiny_tree


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one; run on the "
        "card with python3 -m pytest port_bench/tests -m card)")


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory) -> Path:
    return make_tiny_tree(tmp_path_factory.mktemp("bench"))

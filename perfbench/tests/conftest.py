"""Fixtures of the benchmark's CPU tests."""

import pytest

from small_bench import make_root


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    """A temporary checkout root holding a small copy of the benchmark."""
    return make_root(tmp_path_factory.mktemp("bench"))

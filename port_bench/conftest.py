"""Registers the ``gpu`` marker for the benchmark's own tests (those
under ``tests/`` register it in their conftest), and holds each test to
two intra-op threads: the tests' runs are small, and a pytest worker that
takes every core slows its neighbours."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (skips without one)")


@pytest.fixture(autouse=True)
def _two_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)

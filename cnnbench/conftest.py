"""Test settings of the benchmark's own tests (``test_cnnbench_*.py``).

``card`` marks a test that needs a CUDA device; each such test takes the
``cuda`` fixture, which decides inside the test whether there is one and
skips here without it. Run them on the card with:

    PYTHONPATH=src python -m pytest -q -m card cnnbench
"""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and the small CPU models gain nothing from more."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")

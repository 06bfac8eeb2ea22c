"""The ``card`` marker and fixture: a test that needs a CUDA device skips
where none is present, decided when the test runs."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")

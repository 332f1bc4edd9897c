"""pytest settings of the benchmark's own tests (`benchmark/tests/`):
the ``card`` marker for tests that need a CUDA card, and the fixture that
skips them where there is none (decided inside the fixture, never while a
module is imported)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")

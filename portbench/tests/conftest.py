"""The benchmark's tests. Tests marked ``card`` need a CUDA card and run on
the chip (``python3 -m pytest portbench/tests -m card``); elsewhere they
skip, decided when each test runs."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the chip)")


@pytest.fixture(autouse=True)
def _card_or_skip(request):
    if request.node.get_closest_marker("card") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; run on the chip")

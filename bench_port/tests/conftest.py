"""Tests of the port's benchmark harness. They run on the CPU at tiny
sizes; those marked `card` need a CUDA card and skip without one (decided
in the `card` fixture, never at import)."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

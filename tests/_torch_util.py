"""What the port's test modules share (tests/test_torch_*.py).

`one_thread`: imported into a module, an autouse fixture that pins torch to
one intra-op thread for the module, its module fixtures included. At these
shapes one thread is as fast as many, and it keeps the parallel test
workers from oversubscribing the shared cores (each torch op's threads spin
while they wait)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

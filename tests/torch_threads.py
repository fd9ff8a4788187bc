"""One intra-op thread for the port's CPU tests.

pytest-xdist runs several test files at once, each in a worker process of
its own, on a machine with a few cores, and the reference's XLA computations
in those workers keep a thread pool of their own. torch's default pool (a
thread a core) in every worker oversubscribes the cores: its threads spin
and wait on each other, and the suite runs slower than with one thread a
worker. A test module takes this by importing the fixture:

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

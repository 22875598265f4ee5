"""Torch intra-op thread counts for the port's CPU tests.

Under the tier's six workers on one shared CPU, eight torch threads a
process make the port's many small operations wait on each other: a
``train_net_torch.main`` test took 93 s beside five busy processes and 2 s
alone. A module that uses ``one_torch_thread_module`` runs torch on one
thread and restores the count after its last test.

On one thread the order of torch's sums changes. Where that flips a ReLU of
a random backbone in a comparison with JAX, the test takes
``default_torch_threads`` and runs at the count the process started with; its
tolerance and its seed stay as they were.
"""

import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(scope="module")
def one_torch_thread_module():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def default_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(n)

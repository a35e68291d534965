"""A module fixture for the port's CPU tests: two threads for PyTorch and
for the BLAS and OpenMP pools of the process.

The test suite runs in several worker processes at once, each with JAX's
thread pool beside PyTorch's and numpy's; with one thread per core in every
pool the small products of these tests spend most of their time waiting,
and a file runs several times slower than on its own.  Import the fixture
into a test module to apply it there::

    from torch_threads import few_threads  # noqa: F401
"""

import pytest
import threadpoolctl
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    with threadpoolctl.threadpool_limits(THREADS):
        yield
    torch.set_num_threads(n)

"""One PyTorch intra-op thread for the port's CPU tests.

The test lane runs several pytest workers on one machine.  With
PyTorch's default of one OpenMP thread per core in every worker, the
cores are oversubscribed, and every call made of many small ops (the
plain kernels' gathers, the geometry's fixed-sweep linear algebra)
waits on threads that other workers hold: the port's test files took
240 s under 6 workers on 8 cores, against 90 s with one thread per
worker.  A test module imports the fixture to run its tests on one
thread:

    from torch_threads import one_torch_thread  # noqa: F401 (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

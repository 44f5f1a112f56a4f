"""One intra-op CPU thread for the port's tests.

The suite runs in several worker processes on one machine, and PyTorch's CPU
ops default to one OpenMP thread per core in every process: the workers'
threads then wait on each other at every parallel op.  Six concurrent runs of
the port's ECC loop (180x320, 30 iterations, three calls) took 366 s each at
8 threads on 8 cores, and 0.55 s each at one thread.  Each ``test_torch_*``
module imports :func:`one_torch_thread`, which runs its tests on one thread
and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""One intra-op thread for the port's CPU tests.

The port's tests run small PyTorch workloads, as fast on one thread as on
a full OpenMP pool. Under the suite's parallel workers a full pool in each
process oversubscribes the cores and every worker slows down. A test
module that imports :func:`one_intra_op_thread` runs on one thread; the
count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

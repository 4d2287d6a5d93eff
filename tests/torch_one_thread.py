"""One compute thread for a port test module and its reference
subprocesses.

The port's tests use small arrays, and the suite runs several pytest
workers at once: a torch (or XLA) thread pool per worker as wide as the
machine oversubscribes the cores and slows every worker down many times
over.  A test module imports :func:`one_torch_thread` (an autouse fixture)
and passes :data:`XLA_ONE_THREAD` to its JAX subprocesses.
"""
import pytest
import torch

XLA_ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

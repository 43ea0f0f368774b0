"""The port tests' CPU work in one torch thread: an autouse fixture a
tests/test_torch_port_*.py file takes by name. Tier-1 runs six xdist
workers beside the JAX package's own thread pools; torch's default of one
thread per core then oversubscribes the cores, and a test file took up to
20 times its time alone. Its scope is the module, so that the module's
fixtures compute in the thread count its tests do (a reduction's order
follows the thread count); tests/test_torch_port_zoo_train.py keeps a
function-scoped one (its docstring says why)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

"""Fixtures shared by the port's CPU test files: each
`tests/test_torch_port_*.py` imports them by name, which is how pytest
finds a fixture defined outside the file and outside the conftest."""
import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """torch on THREADS intra-op threads for the module.  The tier-1 run
    has six xdist workers on the machine's cores beside XLA's own
    pools; at torch's default (a thread per core) each worker's torch
    takes every core and the suite's port tests took several times their
    time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)

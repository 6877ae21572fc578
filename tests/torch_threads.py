"""A fixture for the port's heavier CPU test files: run torch on one
thread while the module's tests run.

The suite runs several test processes on a few cores. There torch's
worker threads spin between parallel regions and slow every process, and
one thread is faster. A test module opts in with
``from torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

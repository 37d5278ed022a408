"""Shared by the port's test modules (a helper, not a test module): a
module-scoped autouse fixture that runs the module's torch work on one
CPU thread.

The suite runs in six pytest-xdist worker processes on a few cores.
torch's default intra-op pool (a thread per core, spinning between
parallel regions) then oversubscribes the machine beside XLA's pool in
the same worker: the port's small CPU ops slow down up to eighty-fold
(the reduced trainer CLI's 16 steps took 88 s in the whole suite, 1.1 s
alone) and starve every other worker. A module imports the fixture by
name, which makes it autouse for that module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

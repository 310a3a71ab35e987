"""One torch intra-op thread for the port's CPU test modules.

The suite runs in several worker processes on the same cores.  Each
process's torch would start as many intra-op threads as there are cores,
and the port's small CPU ops then spend their time waiting on each other:
a module that takes ~25 s alone took ~700 s beside five busy workers.  A
module imports `one_torch_thread` to run on one thread and restore the
count after; results within a module do not depend on it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""An autouse fixture that runs a test module's torch work on one intra-op
thread and restores the count after the module. Beside the other test
workers, a pool of intra-op threads stalls at every parallel region once
the CPU is oversubscribed. A module takes it with

    from _torch_one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""One intra-op torch thread per test module of the port (no tests here).

The reduced models' ops are small, so one thread each keeps the test
workers that run beside a module from oversubscribing the cores.  A module
takes the fixture with ``from test_torch_threads import one_torch_thread  #
noqa: F401``; the previous count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

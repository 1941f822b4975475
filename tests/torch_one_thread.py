"""One torch thread for the port's CPU tests.

The Tier-1 run starts six pytest workers on a host of a few cores, and
each worker's torch would start an intra-op pool of a thread a core: the
pools then contend for the cores, and the port's tests ran 2.1 times
longer in all than on one thread (ROADMAP.md §3, F3). Every
``tests/test_torch_*.py`` imports the fixture below, which pytest then
runs around each of its modules::

    from torch_one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

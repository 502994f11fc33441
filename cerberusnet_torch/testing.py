"""Set-up shared by the port's test modules (``tests/test_torch_*.py``).

A module takes the fixture by importing it::

    from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread for the importing module. Tier-1 runs a
    worker process per core, and torch's default of a thread per core makes
    each worker's waiting threads spin on the others' cores (a tiny train
    step took 13 times as long under that load); the tests' shapes need
    one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

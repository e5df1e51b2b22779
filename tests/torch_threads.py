"""The torch thread pin every port test file imports.

The suite runs several workers beside JAX's threads; torch's own thread
pool on top of them oversubscribes the cores, and each test slows down
many times over.  A port test file that runs torch on the CPU imports the
fixture (``from torch_threads import one_torch_thread  # noqa: F401``), so
its tests run torch on one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for the module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

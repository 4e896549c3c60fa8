"""An autouse fixture that runs each test of a module on one torch thread.

The port's CPU tests run many small torch ops (the kernels' emulations,
tiny models' steps). Under pytest-xdist every worker's intra-op threads
contend for the same cores, which made the emulation tests ~35x slower
than on one thread. A test module opts in by importing the fixture:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

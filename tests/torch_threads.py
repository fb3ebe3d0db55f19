"""One intra-op thread for torch in a test module of the port.

The port's CPU paths in these tests are many small tensor operations. With
torch's default pool (a thread per core) in each pytest worker, the workers'
threads contend for the cores and every small operation waits on the
others; one thread per worker removes that wait. The count is restored when
the module's tests end. A module opts in with
``from torch_threads import one_torch_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

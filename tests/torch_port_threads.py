"""One intra-op torch thread for a port test module (import
``one_torch_thread`` into it; pytest applies the autouse fixture there).

The port's tests run tiny models, as fast on one thread; under the parallel
Tier-1 run every worker's torch otherwise takes all the CPUs the workers
share, and the small ops spin against each other: the tiny GRPO epochs ran
50-200x slower than alone. The count is restored after the module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

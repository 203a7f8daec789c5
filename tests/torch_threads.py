"""PyTorch's CPU thread count in the port's tests (imports torch only).

``shared_cores`` (autouse, imported by each CPU port test file) gives
each test process its share of the machine's cores: all of them on one
worker, one each under the suite's ``-n 6``, where a pool of one thread
per core in every worker oversubscribed the machine (ROADMAP, the test
budget). ``one_torch_thread`` (autouse, for the function-level parity
tests of tens of thousands of lanes) runs PyTorch on one thread whatever
the workers: with its OpenMP pool a ``cos`` or ``sin`` came out ~1e-4 off
on one thread's chunk in some processes on the test machine (ROADMAP
Queue C), which no parity test's tolerance should have to absorb.

    from torch_threads import shared_cores  # noqa: F401 (autouse)
"""

import os

import pytest
import torch


def threads_per_worker() -> int:
    """The machine's cores over the pytest-xdist workers (at least 1)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


def _with_threads(n: int):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def shared_cores():
    yield from _with_threads(threads_per_worker())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from _with_threads(1)

"""PyTorch's intra-op threads for the port's CPU tests: under pytest-xdist,
one per worker.

PyTorch starts one OpenMP thread per core in every process. With several
xdist workers on one machine that is workers x cores threads, which spin
while they wait for each other, and a port test took tens of times its
time alone. Every `tests/test_torch_*.py` imports this module, so each
worker sets one thread at collection (the workers share the cores; one
thread also gives every machine the same sums). Outside xdist it changes
nothing. A module whose f32 limits were set at torch's default thread
count, and whose reading depends on it, runs under `default_threads()`.
"""

import contextlib
import os

import torch

DEFAULT = torch.get_num_threads()


@contextlib.contextmanager
def default_threads():
    """Torch's default intra-op threads for the duration (CPU kernels such
    as convolutions split their sums by thread, so a reading moves with
    the count)."""
    shared = torch.get_num_threads()
    torch.set_num_threads(DEFAULT)
    try:
        yield
    finally:
        torch.set_num_threads(shared)


if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) > 1:
    torch.set_num_threads(1)

"""The thread cap of the port's CPU tests.

The suite runs several test processes on the CPU at once (pytest-xdist),
and torch's default of an intra-op thread a core made them thrash: each of
the port's many small operations meets a barrier of 8 OpenMP threads that
the other processes keep off the cores.  chip_smoke.py's main-path and mha
phases (`test_chip_smoke_phases_on_cpu`) took 5 s alone on an 8-core host
and 191 s beside 5 processes that kept its cores busy; at 2 threads 10 s.  Every port test
file imports `two_threads` (autouse, module scope), which holds torch to 2
intra-op threads and hands OMP_NUM_THREADS=2 to the processes it starts
(the CLIs, worker ranks that set no count of their own).
"""

import os

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env

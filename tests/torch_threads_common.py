"""The port's CPU tests under pytest-xdist: each worker's torch runs on its
share of the CPU's cores, not on all of them.

By default every process's torch (and the subprocesses it starts: the native
host, the AOTInductor packaging of its stages, the commands) spreads each
operation over every core, so that W workers on C cores keep W x C
threads in each other's way.  Imported by the port's shared test
helpers: under xdist (``PYTEST_XDIST_WORKER_COUNT`` set) it caps torch's
intra-op threads at the worker's share, ``cores // workers`` and at least
1, and sets ``OMP_NUM_THREADS`` to it for the subprocesses, where the
caller has not set it.  A run without xdist keeps every core.  The checks
are the same: a thread count changes only how a sum is split among threads.
"""

import os

import torch


def worker_threads() -> int:
    """This xdist worker's share of the cores (all of them outside xdist)."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // workers)


if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    THREADS = worker_threads()
    torch.set_num_threads(THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))

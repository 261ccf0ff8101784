"""One share of the host's CPUs for torch in each process of the port's
CPU tests.

pytest-xdist runs ``PYTEST_XDIST_WORKER_COUNT`` workers at once; left
alone, torch's intra-op pool takes every CPU in each of them, and their
OpenMP threads spin against each other until the suite runs many times
slower.  Every ``tests/test_torch_*.py`` imports this module before it
uses torch: it gives torch the CPUs this process may run on divided by the
workers (at least one), and sets ``OMP_NUM_THREADS`` to the same number so
that the child processes a test starts (CLI runs, gloo worlds) inherit the
cap.  Run alone (no xdist), a test file keeps every CPU.
"""

import os

import torch


def share() -> int:
    """The CPUs this process may use over the xdist workers, at least 1."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:
        cpus = os.cpu_count() or 1
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT", "")
    return max(1, cpus // max(1, int(workers) if workers.isdigit() else 1))


THREADS = share()
if torch.get_num_threads() != THREADS:
    torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)

"""Imported by every `tests/test_torch_*.py` right after torch: caps
torch's intra-op threads at this process's share of the cores.

Under `pytest -n N` each of the N worker processes would otherwise start
one torch (OpenMP) thread a core, and N such pools on the same cores spend
most of their time waiting for each other: a test that takes 12 s alone
ran for minutes among six workers. With one worker the cap is every core,
as before. `OMP_NUM_THREADS` carries the same share to the rank
subprocesses a test starts, unless the test sets its own.
"""

import os

import torch


def share() -> int:
    """The cores of this process's affinity mask over the xdist workers."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    cores = len(os.sched_getaffinity(0))
    return max(1, cores // max(1, workers))


THREADS = share()
torch.set_num_threads(THREADS)
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))

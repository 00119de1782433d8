"""Thread-pool map/foreach helper.

Parity: reference `parallel/Parallelization.java` — run a collection of
tasks (`runInParallel`) or apply a function to every item
(`iterateInParallel` with `RunnableWithParams`) on a bounded pool.  Host-
side only: device work goes through the mesh and its collectives, but data prep,
IO fan-out, and coordinator plumbing still want a simple parallel map.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence, TypeVar

E = TypeVar("E")
R = TypeVar("R")


def run_in_parallel(tasks: Iterable[Callable[[], R]],
                    max_workers: Optional[int] = None) -> List[R]:
    """Run zero-arg callables on a pool sized to the CPU count
    (`Parallelization.runInParallel`); blocks until all complete and
    returns their results in task order.  The first raised exception
    propagates after the pool drains."""
    tasks = list(tasks)
    if not tasks:
        return []
    workers = max_workers or min(len(tasks), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return [f.result() for f in [pool.submit(t) for t in tasks]]


def iterate_in_parallel(items: Sequence[E], fn: Callable[[E], R],
                        max_workers: Optional[int] = None) -> List[R]:
    """Apply `fn` to every item in parallel
    (`Parallelization.iterateInParallel` / RunnableWithParams), returning
    results in item order."""
    return run_in_parallel([lambda it=it: fn(it) for it in items],
                           max_workers=max_workers)

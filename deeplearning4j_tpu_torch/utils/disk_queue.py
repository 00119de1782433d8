"""Disk-backed FIFO queue.

The port's copy of `deeplearning4j_tpu/utils/disk_queue.py` (stdlib
only), for the coordinator's update spill.

Parity: reference `util/DiskBasedQueue.java` — a Queue that spills every
element to its own file on disk so arbitrarily large work lists (dataset
shards, worker updates between rounds) never hold heap memory. Used by the
distributed runtime's update saver path.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
from collections import deque
from typing import Any, Optional


class DiskBasedQueue:
    def __init__(self, directory: Optional[str] = None):
        self._dir = directory or tempfile.mkdtemp(prefix="dl4jtpu-queue-")
        os.makedirs(self._dir, exist_ok=True)
        self._order: deque = deque()
        self._counter = 0
        self._lock = threading.Lock()

    def add(self, item: Any) -> None:
        with self._lock:
            name = os.path.join(self._dir, f"{self._counter:012d}.pkl")
            self._counter += 1
            tmp = name + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(item, f)
            os.replace(tmp, name)  # atomic publish
            self._order.append(name)

    def poll(self) -> Optional[Any]:
        """Remove and return the head, or None if empty."""
        with self._lock:
            if not self._order:
                return None
            name = self._order.popleft()
        with open(name, "rb") as f:
            item = pickle.load(f)
        os.remove(name)
        return item

    def peek(self) -> Optional[Any]:
        # read under the lock: a concurrent poll() may delete the head file
        with self._lock:
            if not self._order:
                return None
            with open(self._order[0], "rb") as f:
                return pickle.load(f)

    def is_empty(self) -> bool:
        with self._lock:
            return not self._order

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    def close(self) -> None:
        shutil.rmtree(self._dir, ignore_errors=True)
        self._order.clear()

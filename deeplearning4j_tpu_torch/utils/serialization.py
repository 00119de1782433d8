"""Object serialization helpers.

Parity: reference `util/SerializationUtils.java` — one-call save/load of
models and intermediate state (the reference uses Java serialization; here
pickle with atomic writes). Structured training checkpoints (params +
updater + step) live in `parallel/checkpoint.py`; this module is the
generic small-object path (vocab caches, iterators, host-side state).
"""

from __future__ import annotations

import os
import pickle
from typing import Any


def save_object(obj: Any, path: str) -> None:
    """Atomically pickle obj to path (`SerializationUtils.saveObject`)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_object(path: str) -> Any:
    """Unpickle from path (`SerializationUtils.readObject`)."""
    with open(path, "rb") as f:
        return pickle.load(f)

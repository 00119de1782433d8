"""Collection utilities.

Parity: reference `util/MultiDimensionalMap.java`/`MultiDimensionalSet`,
`util/Index.java` (word index), and the vendored Berkeley NLP collections
(`berkeley/Counter.java`, `berkeley/CounterMap.java`) the NLP stack uses
for vocab statistics.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Generic, Hashable, Iterator, List, Optional, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
K2 = TypeVar("K2", bound=Hashable)
V = TypeVar("V")


class Counter(Generic[K]):
    """Real-valued counter with normalize/argmax (`berkeley/Counter`)."""

    def __init__(self):
        self._counts: Dict[K, float] = defaultdict(float)

    def increment_count(self, key: K, amount: float = 1.0) -> None:
        self._counts[key] += amount

    def set_count(self, key: K, value: float) -> None:
        self._counts[key] = value

    def get_count(self, key: K) -> float:
        return self._counts.get(key, 0.0)

    def total_count(self) -> float:
        return sum(self._counts.values())

    def normalize(self) -> None:
        total = self.total_count()
        if total != 0:
            for k in self._counts:
                self._counts[k] /= total

    def arg_max(self) -> Optional[K]:
        if not self._counts:
            return None
        return max(self._counts, key=self._counts.get)

    def remove_key(self, key: K) -> None:
        self._counts.pop(key, None)

    def keys_sorted_by_count(self, descending: bool = True) -> List[K]:
        return sorted(self._counts, key=self._counts.get,
                      reverse=descending)

    def key_set(self):
        return self._counts.keys()

    def items(self):
        return self._counts.items()

    def __len__(self) -> int:
        return len(self._counts)

    def __contains__(self, key: K) -> bool:
        return key in self._counts


class CounterMap(Generic[K, K2]):
    """Two-level counter: key -> Counter (`berkeley/CounterMap`)."""

    def __init__(self):
        self._maps: Dict[K, Counter] = {}

    def increment_count(self, key: K, sub: K2, amount: float = 1.0) -> None:
        self.get_counter(key).increment_count(sub, amount)

    def get_count(self, key: K, sub: K2) -> float:
        c = self._maps.get(key)
        return 0.0 if c is None else c.get_count(sub)

    def get_counter(self, key: K) -> Counter:
        if key not in self._maps:
            self._maps[key] = Counter()
        return self._maps[key]

    def total_count(self) -> float:
        return sum(c.total_count() for c in self._maps.values())

    def normalize(self) -> None:
        for c in self._maps.values():
            c.normalize()

    def key_set(self):
        return self._maps.keys()

    def __len__(self) -> int:
        return len(self._maps)


class MultiDimensionalMap(Generic[K, K2, V]):
    """Map keyed by a (first, second) pair (`util/MultiDimensionalMap`)."""

    def __init__(self):
        self._backing: Dict[Tuple[K, K2], V] = {}

    def put(self, first: K, second: K2, value: V) -> None:
        self._backing[(first, second)] = value

    def get(self, first: K, second: K2, default: Optional[V] = None):
        return self._backing.get((first, second), default)

    def contains(self, first: K, second: K2) -> bool:
        return (first, second) in self._backing

    def remove(self, first: K, second: K2) -> None:
        self._backing.pop((first, second), None)

    def values(self):
        return self._backing.values()

    def entry_set(self):
        return self._backing.items()

    def __len__(self) -> int:
        return len(self._backing)


class Index:
    """Bidirectional word <-> id index (`util/Index.java`)."""

    def __init__(self):
        self._objects: List = []
        self._indexes: Dict = {}

    def add(self, obj) -> int:
        if obj in self._indexes:
            return self._indexes[obj]
        self._indexes[obj] = len(self._objects)
        self._objects.append(obj)
        return len(self._objects) - 1

    def index_of(self, obj) -> int:
        return self._indexes.get(obj, -1)

    def get(self, i: int):
        return self._objects[i]

    def __len__(self) -> int:
        return len(self._objects)

    def __iter__(self) -> Iterator:
        return iter(self._objects)

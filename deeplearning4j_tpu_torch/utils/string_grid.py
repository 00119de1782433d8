"""String table clustering/dedup.

Parity: reference `util/StringGrid.java` (row/column string table with
fingerprint-based duplicate clustering) and `util/FingerPrintKeyer.java`
(OpenRefine-style key collision method: lowercase, strip punctuation,
unique sorted tokens).
"""

from __future__ import annotations

import re
import string
from collections import defaultdict
from typing import Dict, List

_PUNCT = re.compile("[" + re.escape(string.punctuation) + "]")


def fingerprint(s: str) -> str:
    """Canonical key: trim, lowercase, strip punctuation, unique sorted
    whitespace-split tokens re-joined (`FingerPrintKeyer.key`)."""
    s = _PUNCT.sub("", s.strip().lower())
    return " ".join(sorted(set(s.split())))


class StringCluster(dict):
    """`util/StringCluster.java` parity: {fingerprint -> {variant ->
    count}} over a list of strings, with clusters ordered by size and a
    canonical (most frequent) variant per cluster."""

    def __init__(self, strings: List[str] = ()):
        super().__init__()
        for s in strings:
            self.add(s)

    def add(self, s: str) -> None:
        m = self.setdefault(fingerprint(s), {})
        m[s] = m.get(s, 0) + 1

    def clusters(self) -> List[Dict[str, int]]:
        """Variant maps (copies — mutating them cannot corrupt this
        cluster), largest cluster first (StringCluster.getClusters +
        sort)."""
        return [dict(m) for m in
                sorted(self.values(), key=lambda m: -sum(m.values()))]

    def canonical(self, s: str) -> str:
        """The most frequent variant in s's cluster (ties: lexical)."""
        m = self.get(fingerprint(s))
        if not m:
            return s
        return max(sorted(m), key=lambda v: m[v])


class StringGrid:
    """A list of string rows with fingerprint clustering on a column."""

    def __init__(self, sep: str = ",", rows: List[List[str]] = None):
        self.sep = sep
        self.rows: List[List[str]] = rows or []

    @staticmethod
    def from_lines(lines: List[str], sep: str = ",") -> "StringGrid":
        return StringGrid(sep, [line.split(sep) for line in lines])

    def add_row(self, row: List[str]) -> None:
        self.rows.append(row)

    def get_column(self, col: int) -> List[str]:
        return [r[col] for r in self.rows]

    def cluster_column(self, col: int) -> Dict[str, List[int]]:
        """Row indices grouped by column fingerprint — rows in the same
        group are near-duplicates (`StringGrid.combineColumns` use case)."""
        groups: Dict[str, List[int]] = defaultdict(list)
        for i, r in enumerate(self.rows):
            groups[fingerprint(r[col])].append(i)
        return dict(groups)

    def dedup_by_column(self, col: int) -> "StringGrid":
        """Keep the first row of each fingerprint cluster."""
        keep = sorted(idx[0] for idx in self.cluster_column(col).values())
        return StringGrid(self.sep, [self.rows[i] for i in keep])

    def filter_rows_containing(self, col: int, text: str) -> "StringGrid":
        return StringGrid(
            self.sep, [r for r in self.rows if text in r[col]])

    def __len__(self) -> int:
        return len(self.rows)

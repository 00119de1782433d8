"""Distributed word count — the scaleout 'hello world'.

The port of `deeplearning4j_tpu/scaleout/wordcount.py` (reference
`scaleout/perform/text/` word-count example, `WordCountTest`): jobs =
document batches, result = per-job Counter, aggregate = merged Counter. It
runs on the host; nothing of it touches a device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from deeplearning4j_tpu_torch.parallel.coordinator import (LocalRunner,
                                                           StateTracker)
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.utils.collections import Counter


def distributed_word_count(documents: Sequence[str], n_workers: int = 4,
                           tokenizer_factory=None,
                           tracker: Optional[StateTracker] = None
                           ) -> Counter:
    tok = tokenizer_factory or DefaultTokenizerFactory()
    chunk = max(1, len(documents) // n_workers)
    jobs = [list(documents[i:i + chunk])
            for i in range(0, len(documents), chunk)]

    def perform(docs: List[str]) -> Counter:
        c = Counter()
        for d in docs:
            for w in tok.tokenize(d):
                c.increment_count(w)
        return c

    def aggregate(results: List[Counter]) -> Counter:
        merged = Counter()
        for c in results:
            for w, n in c.items():
                merged.increment_count(w, n)
        return merged

    runner = LocalRunner(perform, aggregate, n_workers=n_workers,
                         tracker=tracker or StateTracker())
    return runner.run(jobs)

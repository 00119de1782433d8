"""Distributed NLP performers, the parameter server and provisioning.

The port of `deeplearning4j_tpu/scaleout/` (reference
`scaleout/perform/models/word2vec/Word2VecPerformer.java:50-426`: jobs =
sentence batches against snapshots of syn0/syn1, results = row deltas
merged by `Word2VecJobAggregator`; the GloVe twin
`scaleout/perform/models/glove/`; the word-count example
`scaleout/perform/text/`).

The inner math of a job is the single-process models' own step
(`models/word2vec.w2v_step`, `models/glove.glove_step`) on the tables'
device; the scaleout layer chunks the work, snapshots the tables and
merges the deltas on that device, through the host coordinator
(`parallel/coordinator.LocalRunner`). `param_server`, `ps_worker` and
`provision` are imported by their module paths, as in the JAX package.
"""

from deeplearning4j_tpu_torch.scaleout.word2vec_performer import (
    DistributedWord2Vec)
from deeplearning4j_tpu_torch.scaleout.glove_performer import DistributedGlove
from deeplearning4j_tpu_torch.scaleout.wordcount import distributed_word_count

__all__ = ["DistributedWord2Vec", "DistributedGlove",
           "distributed_word_count"]

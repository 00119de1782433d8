"""Canonical model configurations and the embedding model families.

zoo               — canonical configs (charTransformer, char-LSTM)
char_lstm         — char-LSTM decoding
word2vec          — skip-gram with hierarchical softmax + negative sampling
glove             — co-occurrence weighted least squares
paragraph_vectors — doc embeddings on top of word2vec
embeddings        — lookup tables, queries and word2vec file formats
"""

from deeplearning4j_tpu_torch.models.embeddings import (InMemoryLookupTable,
                                                        read_word_vectors,
                                                        write_word_vectors)
from deeplearning4j_tpu_torch.models.glove import Glove
from deeplearning4j_tpu_torch.models.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.models.word2vec import Word2Vec

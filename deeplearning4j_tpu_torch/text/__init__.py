"""Text infrastructure for the embedding models: copies of the JAX
package's `text/` modules that the port needs (the port imports nothing of
`deeplearning4j_tpu`).

  sentence_iterator — collection, line, file and label-aware iterators
  tokenization      — Tokenizer/TokenizerFactory + InputHomogenization
  stopwords         — StopWords list
  vocab             — VocabCache/VocabWord + Huffman coding
  corpus            — TokenCorpus, the two-pass corpus view
"""

from deeplearning4j_tpu_torch.text.sentence_iterator import (
    CollectionSentenceIterator, FileSentenceIterator,
    LabelAwareSentenceIterator, LineSentenceIterator)
from deeplearning4j_tpu_torch.text.tokenization import (
    DefaultTokenizer, DefaultTokenizerFactory, input_homogenization)
from deeplearning4j_tpu_torch.text.vocab import Huffman, VocabCache, VocabWord

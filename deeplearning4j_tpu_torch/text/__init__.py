"""Text infrastructure for the embedding models: copies of the JAX
package's `text/` modules that the port needs (the port imports nothing of
`deeplearning4j_tpu`).

  sentence_iterator — collection, line, file and label-aware iterators
  tokenization      — Tokenizer/TokenizerFactory + InputHomogenization
  stopwords         — StopWords list
  vocab             — VocabCache/VocabWord + Huffman coding
  corpus            — TokenCorpus, the two-pass corpus view
  windows           — moving-window featurization
  inverted_index    — corpus store for mini-batched embedding training
  vectorizers       — BagOfWords / TF-IDF
  pos, hmm_pos      — PoS tagging (rules; the bundled HMM over Viterbi)
  sentiment_lexicon — SentiWordNet-style scored lexicon
  tree_parser       — sentences to binary trees for the tree models
"""

from deeplearning4j_tpu_torch.text.sentence_iterator import (
    CollectionSentenceIterator, FileSentenceIterator,
    IndexSentenceIterator, LabelAwareSentenceIterator, LineSentenceIterator)
from deeplearning4j_tpu_torch.text.tokenization import (
    DefaultTokenizer, DefaultTokenizerFactory, input_homogenization)
from deeplearning4j_tpu_torch.text.vocab import Huffman, VocabCache, VocabWord

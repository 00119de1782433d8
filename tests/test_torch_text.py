"""The port's text modules against the JAX package's.

`deeplearning4j_tpu_torch/text/` holds copies of the JAX package's text
modules (the port imports nothing of it). The embedding tables are indexed
by the vocabulary's word order and the Huffman codes and points, so these
must be equal, array for array: the vocabulary, `Huffman.padded_arrays`,
tokenization, the corpus view, the sentence iterators and the skip-gram
pairs `Word2Vec._pairs` draws from one seed. Two corpora: the two-cluster
corpus of tests/test_embeddings.py and a small zipf corpus made as
bench.py:368-381 makes the word2vec bench's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.models.word2vec import Word2Vec as JaxWord2Vec  # noqa: E402,E501
from deeplearning4j_tpu.text import corpus as jax_corpus  # noqa: E402
from deeplearning4j_tpu.text import sentence_iterator as jax_iter  # noqa: E402
from deeplearning4j_tpu.text import stopwords as jax_stop  # noqa: E402
from deeplearning4j_tpu.text import tokenization as jax_tok  # noqa: E402
from deeplearning4j_tpu.text import vocab as jax_vocab  # noqa: E402
from deeplearning4j_tpu_torch.models.word2vec import Word2Vec  # noqa: E402
from deeplearning4j_tpu_torch.text import corpus, sentence_iterator  # noqa: E402,E501
from deeplearning4j_tpu_torch.text import stopwords, tokenization, vocab  # noqa: E402,E501


def cluster_corpus(n=200, seed=0):
    """tests/test_embeddings.py:18-28: {cat,dog,pet,...} vs
    {car,truck,road,...} sentences of 8 words."""
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    vehicles = ["car", "truck", "road", "wheel", "engine"]
    out = []
    for _ in range(n):
        pool = animals if rng.rand() < 0.5 else vehicles
        out.append(" ".join(rng.choice(pool, size=8)))
    return out


def zipf_corpus(vocab_n=200, n_tokens=4000, sent_len=20, seed=0):
    """bench.py:368-381 at its SMALL size: zipf draws over w0..w{V-1}, as
    token lists of 20."""
    rng = np.random.RandomState(seed)
    freq = 1.0 / np.arange(1, vocab_n + 1)
    tokens = rng.choice(vocab_n, size=n_tokens, p=freq / freq.sum())
    words = np.array([f"w{i}" for i in range(vocab_n)])
    return [list(words[tokens[i:i + sent_len]])
            for i in range(0, n_tokens, sent_len)]


CORPORA = {"clusters": cluster_corpus, "zipf": zipf_corpus}


def _token_lists(sentences, tokenize):
    return [tokenize(s) if isinstance(s, str) else list(s)
            for s in sentences]


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("min_freq", [1, 3])
def test_vocab_order_counts_and_huffman_arrays_equal_jax(name, min_freq):
    toks = _token_lists(CORPORA[name](), str.split)
    ours = vocab.VocabCache(min_freq).fit(toks)
    ref = jax_vocab.VocabCache(min_freq).fit(toks)
    assert ours.words() == ref.words()
    np.testing.assert_array_equal(ours.counts(), ref.counts())
    assert ours.total_word_occurrences == ref.total_word_occurrences
    assert ours.n_docs == ref.n_docs
    for w in ref.words():
        assert ours.index_of(w) == ref.index_of(w)
    assert ours.index_of("absent") == ref.index_of("absent") == -1
    vocab.Huffman.build(ours)
    jax_vocab.Huffman.build(ref)
    for a, b in zip(vocab.Huffman.padded_arrays(ours),
                    jax_vocab.Huffman.padded_arrays(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_huffman_points_are_inner_node_rows_with_the_root_first():
    toks = _token_lists(zipf_corpus(), str.split)
    cache = vocab.Huffman.build(vocab.VocabCache().fit(toks))
    codes, points, mask = vocab.Huffman.padded_arrays(cache)
    n = cache.num_words()
    lengths = mask.sum(axis=1).astype(int)
    assert (points[mask > 0] < n - 1).all() and (points >= 0).all()
    # every path starts at the root, inner node n - 2
    assert (points[:, 0] == n - 2).all()
    # frequent words have short codes
    assert lengths[0] <= lengths[-1]
    assert set(np.unique(codes)) <= {0.0, 1.0}


@pytest.mark.parametrize("text", [
    "The quick,  brown fox!\tjumps", "Café naïve — résumé (x) [y]", ""])
def test_tokenization_and_homogenization_equal_jax(text):
    assert (tokenization.DefaultTokenizerFactory().tokenize(text)
            == jax_tok.DefaultTokenizerFactory().tokenize(text))
    assert (tokenization.input_homogenization(text)
            == jax_tok.input_homogenization(text))
    assert (tokenization.input_homogenization(text, preserve_case=True)
            == jax_tok.input_homogenization(text, preserve_case=True))
    pre = tokenization.DefaultTokenizerFactory(str.upper)
    assert pre.tokenize(text) == jax_tok.DefaultTokenizerFactory(
        str.upper).tokenize(text)
    assert (tokenization.NGramTokenizerFactory(1, 3).tokenize(text)
            == jax_tok.NGramTokenizerFactory(1, 3).tokenize(text))
    tk = tokenization.DefaultTokenizer(text)
    ref = jax_tok.DefaultTokenizer(text)
    assert tk.count_tokens() == ref.count_tokens()
    while ref.has_more_tokens():
        assert tk.next_token() == ref.next_token()
    assert not tk.has_more_tokens()


def test_stop_words_equal_jax():
    assert stopwords.STOP_WORDS == jax_stop.STOP_WORDS
    assert stopwords.is_stop_word("The") and not stopwords.is_stop_word("cat")


def test_token_corpus_walks_a_corpus_twice_like_jax():
    def corpora():
        gen_inner = (t for t in ["x", "y"])
        return [iter(["a b", ["c", "d"], ("e",)]),
                ["a b", (t for t in ["x", "y"]), gen_inner]]

    for ours_src, ref_src in zip(corpora(), corpora()):
        ours = corpus.TokenCorpus(ours_src, str.split)
        ref = jax_corpus.TokenCorpus(ref_src, str.split)
        assert list(ours) == list(ref)
        assert list(ours) == list(ref)       # the second pass too


def test_sentence_iterators_equal_jax(tmp_path):
    lines = ["first line", "", "Second LINE", "third"]
    (tmp_path / "a.txt").write_text("\n".join(lines) + "\n")
    sub = tmp_path / "d"
    sub.mkdir()
    (sub / "b.txt").write_text("in a sub dir\n\nlast\n")
    pairs = [
        (sentence_iterator.CollectionSentenceIterator(lines, str.lower),
         jax_iter.CollectionSentenceIterator(lines, str.lower)),
        (sentence_iterator.LineSentenceIterator(tmp_path / "a.txt"),
         jax_iter.LineSentenceIterator(tmp_path / "a.txt")),
        (sentence_iterator.FileSentenceIterator(tmp_path),
         jax_iter.FileSentenceIterator(tmp_path)),
    ]
    for ours, ref in pairs:
        got = list(ours)
        assert got == list(ref) and got
        assert list(ours) == got              # iteration resets
    ours = sentence_iterator.LabelAwareSentenceIterator(lines[:2], ["A", "B"])
    ref = jax_iter.LabelAwareSentenceIterator(lines[:2], ["A", "B"])
    while ref.has_next():
        assert ours.next_sentence() == ref.next_sentence()
        assert ours.current_label() == ref.current_label()
    with pytest.raises(ValueError, match="align"):
        sentence_iterator.LabelAwareSentenceIterator(lines, ["A"])


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("sample", [0.0, 1e-2])
def test_word2vec_pairs_equal_jax_for_the_same_seed(name, sample):
    sents = CORPORA[name]()
    kw = dict(vector_length=8, window=4, min_word_frequency=1, seed=7,
              sample=sample)
    ours = Word2Vec(device="cpu", **kw)
    ref = JaxWord2Vec(**kw)
    toks = _token_lists(sents, ours.tokenize)
    ours.build_vocab(toks)
    ref.build_vocab(toks)
    ids = [np.asarray([ref.cache.index_of(t) for t in s], np.int32)
           for s in toks]
    for _ in range(2):   # the second draw continues the same stream
        (oc, ox), (rc, rx) = ours._pairs(ids), ref._pairs(ids)
        assert oc.dtype == rc.dtype == np.int32
        np.testing.assert_array_equal(oc, rc)
        np.testing.assert_array_equal(ox, rx)
    assert len(oc) > 0

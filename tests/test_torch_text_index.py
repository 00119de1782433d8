"""The port's windows, Word2Vec window iterator, inverted index and
vectorizers against the JAX package's.

`deeplearning4j_tpu_torch/text/{windows,inverted_index,vectorizers}.py`
and `models/word2vec_iterator.py` are the port's copies (it imports
nothing of the JAX package). On the same numpy-seeded corpora: windows,
label spans and window matrices equal; both index stores answer every
query alike and write byte-equal files; the bag-of-words and TF-IDF
matrices are equal; and the window iterator and fetcher serve
array-equal DataSets over one set of word vectors (a port `Word2Vec`
trained on the CPU, which the JAX iterator reads too: it only calls
`vector`, `vector_length`, `window` and `tokenize`).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.models import word2vec_iterator as jax_w2vit  # noqa: E402,E501
from deeplearning4j_tpu.text import inverted_index as jax_index  # noqa: E402
from deeplearning4j_tpu.text import sentence_iterator as jax_sit  # noqa: E402
from deeplearning4j_tpu.text import vectorizers as jax_vec  # noqa: E402
from deeplearning4j_tpu.text import windows as jax_windows  # noqa: E402
from deeplearning4j_tpu_torch.models import word2vec_iterator as w2vit  # noqa: E402,E501
from deeplearning4j_tpu_torch.models.word2vec import Word2Vec  # noqa: E402
from deeplearning4j_tpu_torch.text import inverted_index, vectorizers  # noqa: E402,E501
from deeplearning4j_tpu_torch.text import sentence_iterator as sit  # noqa: E402,E501
from deeplearning4j_tpu_torch.text import windows  # noqa: E402

WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "far",
         "fast", "good", "bad", "movie", "was", "not"]


def _sentences(n=30, seed=0, lo=2, hi=9):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, size=rng.randint(lo, hi)))
            for _ in range(n)]


def _equal_ds(got, want):
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.fixture(scope="module")
def w2v():
    """A small port Word2Vec on the CPU (both iterators read its
    vectors)."""
    return Word2Vec(vector_length=6, window=3, negative=2,
                    min_word_frequency=1, epochs=1, seed=0, batch_size=32,
                    device="cpu").fit(_sentences())


@pytest.mark.parametrize("size", [1, 3, 5])
def test_windows_equal_jax(size):
    for s in _sentences(8, seed=size):
        toks = s.split()
        got, want = windows.windows(toks, size), jax_windows.windows(toks,
                                                                     size)
        assert [(w.words, w.focus, w.label, w.focus_word()) for w in got] \
            == [(w.words, w.focus, w.label, w.focus_word()) for w in want]
    assert repr(windows.windows(["a"], 3)[0]) == \
        repr(jax_windows.windows(["a"], 3)[0])
    x = np.random.RandomState(size).rand(9, 4)
    for window, stride in ((3, 1), (2, 2), (9, 3)):
        np.testing.assert_array_equal(
            windows.moving_window_matrix(x, window, stride),
            jax_windows.moving_window_matrix(x, window, stride))


def test_window_features_equal_jax(w2v):
    for w in windows.windows("the cat zzz sat".split(), 3):
        np.testing.assert_array_equal(
            windows.window_features(w, w2v.vector, 6),
            jax_windows.window_features(w, w2v.vector, 6))


@pytest.mark.parametrize("sentence", [
    "the <PER> john smith </PER> went to <LOC> paris </LOC> today",
    "<A> x </A>", "plain words only", "", "<A> a </A> <B> b c </B>"])
def test_string_with_labels_equals_jax(sentence):
    assert windows.string_with_labels(sentence) == \
        jax_windows.string_with_labels(sentence)


@pytest.mark.parametrize("bad", ["<A> x </B>", "x </A>", "<A> x",
                                 "<A> <B> x </B> </A>",
                                 "the <PER>john smith</PER> went"])
def test_malformed_markup_raises_as_jax(bad):
    with pytest.raises(ValueError) as a:
        windows.string_with_labels(bad)
    with pytest.raises(ValueError) as b:
        jax_windows.string_with_labels(bad)
    assert str(a.value) == str(b.value)


def test_word2vec_iterator_equals_jax(w2v):
    sents = _sentences(12, seed=4)
    labels = [["A", "B"][i % 2] for i in range(len(sents))]
    for batch, window in ((4, 3), (7, 5)):
        it = w2vit.Word2VecDataSetIterator(
            w2v, sit.LabelAwareSentenceIterator(sents, labels), ["A", "B"],
            batch=batch, window=window)
        jit = jax_w2vit.Word2VecDataSetIterator(
            w2v, jax_sit.LabelAwareSentenceIterator(sents, labels),
            ["A", "B"], batch=batch, window=window)
        assert it.input_columns() == jit.input_columns() == window * 6
        assert it.total_outcomes() == 2
        got, want = list(it), list(jit)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            _equal_ds(g, w)
        # reset replays the same batches
        for g, w in zip(list(it), want):
            _equal_ds(g, w)
    # a plain iterator: every window takes default_label
    plain = w2vit.Word2VecDataSetIterator(
        w2v, sit.CollectionSentenceIterator(sents), ["NONE"], batch=5)
    jplain = jax_w2vit.Word2VecDataSetIterator(
        w2v, jax_sit.CollectionSentenceIterator(sents), ["NONE"], batch=5)
    assert plain.window == 3  # the model's window
    for g, w in zip(plain, jplain):
        _equal_ds(g, w)
    bad = w2vit.Word2VecDataSetIterator(
        w2v, sit.LabelAwareSentenceIterator(sents, labels), ["A"], batch=4)
    with pytest.raises(ValueError, match="not in labels"):
        list(bad)


def test_word2vec_data_fetcher_equals_jax(tmp_path, w2v):
    (tmp_path / "a.txt").write_text(
        "the <PER> cat sat </PER> on <LOC> a mat </LOC>\n"
        "<PER> dog </PER> ran far\n\n"
        "<LOC> bad markup\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.txt").write_text("<LOC> the movie </LOC> was\n")
    labels = ["NONE", "PER", "LOC"]
    f = w2vit.Word2VecDataFetcher(w2v, str(tmp_path), labels, window=3)
    jf = jax_w2vit.Word2VecDataFetcher(w2v, str(tmp_path), labels,
                                       window=3)
    assert f.total_examples() == jf.total_examples() == 12
    assert f.input_columns() == 18 and f.total_outcomes() == 3
    for n in (4, 5, 100):
        _equal_ds(f.fetch(n), jf.fetch(n))
    assert f.fetch(1) is None and jf.fetch(1) is None
    f.reset()
    assert f.has_more()
    with pytest.raises(ValueError, match="positive"):
        f.fetch(0)
    (tmp_path / "c.txt").write_text("<ORG> x </ORG>\n")
    with pytest.raises(ValueError, match="not in labels"):
        w2vit.Word2VecDataFetcher(w2v, str(tmp_path), labels, window=3)


def _fill(idx, docs, labels):
    for d, lbl in zip(docs, labels):
        idx.add_doc(d, lbl)


def _docs(n=40, seed=1):
    rng = np.random.RandomState(seed)
    docs = [list(rng.choice(WORDS, size=rng.randint(1, 10)))
            for _ in range(n)]
    labels = [None if i % 3 == 0 else f"l{i % 2}" for i in range(n)]
    return docs, labels


def _same_answers(ours, ref):
    assert ours.num_documents() == ref.num_documents()
    for i in range(ref.num_documents()):
        assert ours.document(i) == ref.document(i)
        assert ours.label(i) == ref.label(i)
    for w in WORDS + ["absent"]:
        assert ours.documents_containing(w) == ref.documents_containing(w)
        assert ours.doc_frequency(w) == ref.doc_frequency(w)
    assert list(ours.all_docs()) == list(ref.all_docs())


def test_inverted_index_equals_jax(tmp_path):
    docs, labels = _docs()
    ours, ref = inverted_index.InvertedIndex(), jax_index.InvertedIndex()
    _fill(ours, docs, labels)
    _fill(ref, docs, labels)
    _same_answers(ours, ref)
    import random

    assert ours.sample_docs(7, random.Random(3)) == \
        ref.sample_docs(7, random.Random(3))
    assert inverted_index.InvertedIndex().sample_docs(3) == []
    ours.save(str(tmp_path / "m.json"))
    ref.save(str(tmp_path / "j.json"))
    assert (tmp_path / "m.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    _same_answers(inverted_index.InvertedIndex.load(str(tmp_path / "j.json")),
                  ref)


def test_disk_inverted_index_equals_jax(tmp_path):
    docs, labels = _docs(seed=2)
    ours = inverted_index.DiskInvertedIndex(str(tmp_path / "ours"))
    ref = jax_index.DiskInvertedIndex(str(tmp_path / "ref"))
    _fill(ours, docs[:30], labels[:30])
    _fill(ref, docs[:30], labels[:30])
    _same_answers(ours, ref)
    import random

    assert ours.sample_docs(5, random.Random(1)) == \
        ref.sample_docs(5, random.Random(1))
    ours.save()
    ref.save()
    # docs appended after the manifest: a reopen rebuilds from the log
    _fill(ours, docs[30:], labels[30:])
    _fill(ref, docs[30:], labels[30:])
    ours._flush()
    ref._flush()
    ours.close()
    ref.close()
    for name in ("docs.jsonl", "index.json"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    ours2 = inverted_index.DiskInvertedIndex.load(str(tmp_path / "ours"))
    ref2 = jax_index.DiskInvertedIndex.load(str(tmp_path / "ref"))
    _same_answers(ours2, ref2)
    view = ours2.docs()
    assert len(view) == 40 and list(view) == list(ref2.docs())
    os.remove(tmp_path / "ours" / "index.json")
    with inverted_index.DiskInvertedIndex(str(tmp_path / "ours")) as again:
        _same_answers(again, ref2)
    # the context manager saved a fresh manifest
    assert (tmp_path / "ours" / "index.json").exists()
    ours2.close()
    ref2.close()


def test_in_memory_to_disk_and_sentence_iterators_equal_jax(tmp_path):
    docs, labels = _docs(12, seed=5)
    mem, jmem = inverted_index.InvertedIndex(), jax_index.InvertedIndex()
    _fill(mem, docs, labels)
    _fill(jmem, docs, labels)
    disk = mem.to_disk(str(tmp_path / "a"))
    jdisk = jmem.to_disk(str(tmp_path / "b"))
    _same_answers(disk, jdisk)
    for store, jstore in ((mem, jmem), (disk, jdisk)):
        it = sit.IndexSentenceIterator(store, preprocessor=str.upper,
                                       sep="_")
        jit = jax_sit.IndexSentenceIterator(jstore, preprocessor=str.upper,
                                            sep="_")
        assert list(it) == list(jit) and len(list(it)) == 12
    disk.close()
    jdisk.close()
    (tmp_path / "d" / "e").mkdir(parents=True)
    (tmp_path / "d" / "z.txt").write_text("last")
    (tmp_path / "d" / "e" / "a.txt").write_text("inner\ndoc")
    (tmp_path / "d" / "b.txt").write_text("first")
    d, jd = (sit.DocumentIterator(str(tmp_path / "d")),
             jax_sit.DocumentIterator(str(tmp_path / "d")))
    assert list(d) == list(jd) == ["first", "last", "inner\ndoc"]
    assert d.paths() == jd.paths()
    d.reset()
    d.next_document()
    assert d.current_path() == str(tmp_path / "d" / "b.txt")


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
@pytest.mark.parametrize("min_freq, stop", [(1, True), (2, False)])
def test_vectorizers_equal_jax(cls, min_freq, stop):
    sents = _sentences(25, seed=7, lo=3, hi=12)
    labels = [["pos", "neg", "mid"][i % 3] for i in range(len(sents))]
    kw = {} if stop else {"stop_words": ()}
    ours = getattr(vectorizers, cls)(min_word_frequency=min_freq, **kw)
    ref = getattr(jax_vec, cls)(min_word_frequency=min_freq, **kw)
    ours.fit(sents, labels=labels)
    ref.fit(sents, labels=labels)
    assert ours.labels == ref.labels == ["mid", "neg", "pos"]
    assert [ours.cache.word_at_index(i)
            for i in range(ours.cache.num_words())] == \
        [ref.cache.word_at_index(i) for i in range(ref.cache.num_words())]
    queries = _sentences(10, seed=8) + ["zzz unknown", ""]
    np.testing.assert_array_equal(ours.transform_many(queries),
                                  ref.transform_many(queries))
    _equal_ds(ours.vectorize(queries[0], "neg"),
              ref.vectorize(queries[0], "neg"))

"""The port's scaleout layer (`deeplearning4j_tpu_torch/scaleout/`) held to
the JAX package's on the CPU: `randint` bitwise `jax.random.randint`, the
word count equal, the distributed Word2Vec (BSP, SGD and AdaGrad) and
GloVe tables within 1e-5 of JAX's from the same starting tables, the
HogWild run on quality as JAX's own test judges it
(tests/test_scaleout_nlp.py). The parameter-server protocol cases are in
tests/test_torch_param_server.py, `ps_worker` and provisioning in
tests/test_torch_provision.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402

from deeplearning4j_tpu import scaleout as jax_scaleout  # noqa: E402
from deeplearning4j_tpu_torch.nd import kernels  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.parallel.coordinator import StateTracker  # noqa: E402,E501
from deeplearning4j_tpu_torch.scaleout import (  # noqa: E402
    DistributedGlove, DistributedWord2Vec, distributed_word_count)

CORPUS = [
    "the king rules the kingdom with a crown",
    "the queen rules the kingdom with grace",
    "king and queen sit on the royal throne",
    "the cat chases the mouse in the house",
    "a cat and a mouse live in the old house",
    "dogs chase cats and cats chase mice daily",
    "the king wears the royal crown of gold",
    "the queen wears a golden crown today",
    "mouse and cat play in the house garden",
    "royal king and royal queen rule together",
] * 6

TABLES = ("syn0", "syn1", "syn1neg")


# ---------------------------------------------------------------- randint

@pytest.mark.parametrize("seed,folds,shape,lo,hi", [
    (0, (), (5, 3), 0, 100),
    (7, (2, 5), (1000,), 0, 10 ** 8),
    (3, (1,), (4, 5, 6), -50, 2 ** 31 - 1),
    (9, (0, 0, 3), (17,), 5, 5),
    (11, (4,), (8,), -2 ** 31, 2 ** 31 - 1),
    (13, (), (33,), 3, 1),
    (14, (6, 1, 2), (64, 5), 0, 70000),
    (15, (2,), (2048,), 0, 12345678),
])
def test_randint_is_jax_randint_bit_for_bit(seed, folds, shape, lo, hi):
    """Exact: the same int32 values for every shape, range and folded key
    (spans past 2^16 wrap the multiplier in uint32; maxval <= minval gives
    minval)."""
    jkey = jax.random.PRNGKey(seed)
    tkey = nd_random.prng_key(seed)
    for f in folds:
        jkey = jax.random.fold_in(jkey, f)
        tkey = nd_random.fold_in(tkey, f)
    want = np.asarray(jax.random.randint(jkey, shape, lo, hi))
    got = nd_random.randint(tkey, shape, lo, hi)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_takes_a_batch_of_keys_or_a_host_key():
    """A batch of keys [3, 2] draws each key's values; a key held as two
    ints (`fold_in_host`, as the distributed Word2Vec's steps hold theirs)
    draws the same values as its tensor."""
    keys = torch.stack([nd_random.fold_in(nd_random.prng_key(1), i)
                        for i in range(3)])
    got = nd_random.randint(keys, (4, 2), 0, 1000)
    for i in range(3):
        want = jax.random.randint(
            jax.random.fold_in(jax.random.PRNGKey(1), i), (4, 2), 0, 1000)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        host = nd_random.fold_in_host((0, 1), i)
        assert host == tuple(int(v) for v in keys[i])
        np.testing.assert_array_equal(
            nd_random.randint(host, (4, 2), 0, 1000, device="cpu").numpy(),
            np.asarray(want))


# -------------------------------------------------------------- word count

def test_word_count_equals_jax():
    got = distributed_word_count(CORPUS, n_workers=3)
    want = jax_scaleout.distributed_word_count(CORPUS, n_workers=3)
    assert dict(got.items()) == dict(want.items())
    assert got.get_count("king") == sum(s.split().count("king")
                                        for s in CORPUS)


# ---------------------------------------------------------------- word2vec

def _carried_w2v(**kw):
    """A JAX and a port DistributedWord2Vec on one vocabulary, the port's
    tables JAX's fresh ones (carried across with `load_numpy`)."""
    jw = jax_scaleout.DistributedWord2Vec(CORPUS, **kw)
    toks = [jw.tokenize(s) for s in CORPUS]
    jw.build_vocab(toks)
    init = {k: np.array(getattr(jw.table, k)) for k in TABLES
            if getattr(jw.table, k) is not None}
    tw = DistributedWord2Vec(CORPUS, device="cpu", **kw)
    tw.build_vocab(toks)
    tw.table.load_numpy(**init)
    return jw, tw, init


@pytest.mark.parametrize("use_adagrad", [False, True])
def test_bsp_word2vec_matches_jax(use_adagrad):
    """BSP over 3 workers, 2 epochs, 4 jobs an epoch (a short tail job),
    per-job batches with a padded last step: every table within 1e-5 of
    JAX's (measured 2e-8 with SGD, 2e-6 with AdaGrad, whose 1e-8 start
    magnifies rounding), the negatives drawn by the port's `randint` from
    JAX's keys."""
    jw, tw, init = _carried_w2v(
        vector_length=12, window=3, min_word_frequency=2, negative=3,
        epochs=2, batch_size=64, seed=5, n_workers=3, use_adagrad=use_adagrad)
    jw.fit()
    tw.fit()
    for k in TABLES:
        want = np.asarray(getattr(jw.table, k))
        got = getattr(tw.table, k).numpy()
        assert np.abs(want - init[k]).max() > 1e-3, k  # the table trained
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=k)


def test_bsp_word2vec_is_deterministic_across_worker_counts():
    """The keys and the chunks depend on the job, not on the worker that
    runs it: one worker and four give bitwise equal tables."""
    out = []
    for n_workers in (1, 4):
        w = DistributedWord2Vec(CORPUS, vector_length=8, window=3,
                                min_word_frequency=2, negative=2, epochs=1,
                                batch_size=32, seed=2, n_workers=n_workers,
                                jobs_per_round=4, device="cpu")
        w.fit()
        out.append(w.table.syn0.clone())
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("hogwild", [False, True])
def test_word2vec_trains_on_quality_as_jaxs_test(hogwild):
    """tests/test_scaleout_nlp.py's quality check: HogWild applies each
    job's deltas as it ends, racy by design, so it is judged on quality
    only, as in JAX's test."""
    w2v = DistributedWord2Vec(
        CORPUS, vector_length=24, window=4, min_word_frequency=2,
        negative=3, epochs=6, batch_size=256, seed=7, n_workers=3,
        hogwild=hogwild, device="cpu")
    w2v.fit()
    assert w2v.similarity("king", "queen") > w2v.similarity("king", "mouse")
    v = w2v.vector("king")
    assert v.shape == (24,) and np.all(np.isfinite(np.asarray(v)))


def test_tracker_saw_jobs():
    tr = StateTracker()
    DistributedWord2Vec(CORPUS[:20], vector_length=8, epochs=1,
                        min_word_frequency=2, n_workers=2, tracker=tr,
                        device="cpu").fit()
    assert tr.count("jobs_done") > 0


# ------------------------------------------------------------------- glove

@pytest.mark.parametrize("window,offset", [(1, 0), (3, 0), (15, 0),
                                           (3, 2 ** 30)])
def test_cooccurrence_counts_equal_jax(window, offset, monkeypatch):
    """Exact: the port's array counting gives JAX's dict's pairs in its
    order and each count as the same float64 sum, sentence by sentence, in
    one batch, in batches of 50 tokens from a generator, and through the
    distributed chunked count and merge (ids past 2^30 take the np.unique
    path: key and position overflow 62 bits)."""
    from deeplearning4j_tpu.models.glove import CoOccurrences as JaxCo
    from deeplearning4j_tpu.text.vocab import VocabCache as JaxVocab
    from deeplearning4j_tpu_torch.models import glove as glove_mod
    from deeplearning4j_tpu_torch.models.glove import CoOccurrences
    from deeplearning4j_tpu_torch.text.vocab import VocabCache

    rng = np.random.RandomState(window)
    sents = [[int(i) + offset for i in rng.randint(0, 40, rng.randint(0, 25))]
             for _ in range(300)]
    ref = JaxCo(window)
    for s in sents:
        ref.add_sentence(s)
    one, batch = CoOccurrences(window), CoOccurrences(window)
    for s in sents:
        one.add_sentence(s)
    batch.add_sentences(sents[:120])
    batch.add_sentences(sents[120:])
    monkeypatch.setattr(glove_mod, "_BATCH_TOKENS", 50)
    small = CoOccurrences(window)
    small.add_sentences(iter(sents))
    want = np.array(list(ref.counts.values()))
    for co in (one, batch, small):
        for got, exp in zip(co.arrays(), ref.arrays()):
            assert got.dtype == exp.dtype
            np.testing.assert_array_equal(got, exp)
        np.testing.assert_array_equal(co.values, want)
    words = [[f"w{i}" for i in s] for s in sents]
    jd = jax_scaleout.DistributedGlove(window=window, min_word_frequency=1,
                                       n_workers=3)
    td = DistributedGlove(window=window, min_word_frequency=1, n_workers=3,
                          device="cpu")
    jd.cache, td.cache = JaxVocab(1).fit(words), VocabCache(1).fit(words)
    for got, exp in zip(td._count_cooccurrences(words).arrays(),
                        jd._count_cooccurrences(words).arrays()):
        np.testing.assert_array_equal(got, exp)


def test_distributed_glove_matches_jax():
    """Chunked counting, JAX's threefry start, per-job AdaGrad steps,
    summed deltas and max-merged history: the exported vectors within 1e-5
    of JAX's (measured 3e-8), the epoch losses falling."""
    kw = dict(vector_length=8, window=4, epochs=3, lr=0.05, seed=3,
              n_workers=3, batch_size=32)
    j = jax_scaleout.DistributedGlove(CORPUS[:30], **kw).fit()
    t = DistributedGlove(CORPUS[:30], device="cpu", **kw).fit()
    np.testing.assert_allclose(t.table.syn0.numpy(),
                               np.asarray(j.table.syn0), atol=1e-5, rtol=0)
    assert t.epoch_losses[-1] < t.epoch_losses[0]


def test_distributed_glove_trains_sane_vectors():
    g = DistributedGlove(CORPUS, vector_length=16, window=6, epochs=8,
                         lr=0.05, seed=3, n_workers=3, device="cpu").fit()
    v = g.vector("king")
    assert v.shape == (16,) and np.all(np.isfinite(np.asarray(v)))
    assert g.similarity("king", "queen") > g.similarity("king", "mouse")


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_cuda_distributed_word2vec_launches_the_scatter_per_gather():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    w2v = DistributedWord2Vec(CORPUS, vector_length=16, window=3,
                              min_word_frequency=2, negative=3, epochs=1,
                              batch_size=64, seed=2, n_workers=2)
    kernels.reset_launches()
    w2v.fit()
    torch.cuda.synchronize()
    n = kernels.LAUNCHES["scatter_add_rows"]
    assert n > 0 and n % 3 == 0
    assert torch.isfinite(w2v.table.syn0).all()

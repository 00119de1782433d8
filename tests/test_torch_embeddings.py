"""The port's embedding models (word2vec, paragraph vectors, GloVe) against
the JAX package's.

Randomness. The JAX package draws its table inits and its negatives from
threefry keys, which the port does not reproduce (it draws from explicit
`torch.Generator`s). So where the two must compute the same numbers, the
JAX package's starting tables are carried across (`load_numpy`, the
`doc_vectors` and `init` arguments of `fit`), and its negatives are
replayed: the tests record the slots JAX's key schedule gives (one split
per epoch, one per batch inside the scan, word2vec.py:135,330; one per doc
step, paragraph_vectors.py:98) and hand them to the port through
`draw_negative_slots`. The skip-gram pairs and batch order come from the
same numpy stream in both.

Tolerances. One step: 1e-5 * max|table| (f32 sums of the same terms in
another order). A whole `fit`: 1e-4 * max|table|, looser because the
rounding differences of each step feed the next ones over every step of
two epochs, and AdaGrad divides by sqrt(h), which for a row touched once
is |g| itself, so a last-bit difference in a small g moves the update by
up to alpha's order. The port's own RNG is held to the similarity
behaviour of tests/test_embeddings.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.models.paragraph_vectors as jax_pv_mod  # noqa: E402
import deeplearning4j_tpu.models.word2vec as jax_w2v_mod  # noqa: E402
from deeplearning4j_tpu.models import embeddings as jax_emb  # noqa: E402
from deeplearning4j_tpu.models.glove import Glove as JaxGlove  # noqa: E402
from deeplearning4j_tpu.models.paragraph_vectors import (  # noqa: E402
    ParagraphVectors as JaxParagraphVectors)
from deeplearning4j_tpu.models.word2vec import (  # noqa: E402
    Word2Vec as JaxWord2Vec, _w2v_step_impl)
from deeplearning4j_tpu_torch.models import embeddings  # noqa: E402
from deeplearning4j_tpu_torch.models import word2vec as w2v_mod  # noqa: E402
from deeplearning4j_tpu_torch.models.glove import Glove  # noqa: E402
from deeplearning4j_tpu_torch.models.paragraph_vectors import (  # noqa: E402
    ParagraphVectors)
from deeplearning4j_tpu_torch.models.word2vec import (  # noqa: E402
    Word2Vec, add_adagrad_state, w2v_step)
from deeplearning4j_tpu_torch.nd import kernels  # noqa: E402
from deeplearning4j_tpu_torch.text.corpus import TokenCorpus  # noqa: E402
from deeplearning4j_tpu_torch.text.vocab import Huffman  # noqa: E402

STEP_TOL = 1e-5
FIT_TOL = 1e-4
SYN = ("syn0", "syn1", "syn1neg")


def _corpus(n=200, seed=0):
    """tests/test_embeddings.py:18-28: two topic clusters."""
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    vehicles = ["car", "truck", "road", "wheel", "engine"]
    out = []
    for _ in range(n):
        pool = animals if rng.rand() < 0.5 else vehicles
        out.append(" ".join(rng.choice(pool, size=8)))
    return out


def _assert_tables_close(got, want, tol, what=""):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# ------------------------------------------------------------ one step

def _step_inputs(negative, use_hs, seed=30, batch=12):
    """A vocabulary from the cluster corpus, random tables (syn1 and
    syn1neg nonzero so that every gradient term shows), a batch of pairs
    with one weight-0 pair, and JAX's negative slots for one key."""
    model = JaxWord2Vec(vector_length=8, min_word_frequency=1, seed=seed)
    model.build_vocab([s.split() for s in _corpus(40)])
    n = model.cache.num_words()
    rng = np.random.RandomState(seed)
    tables = {"syn0": rng.standard_normal((n, 8)).astype(np.float32) * 0.3,
              "syn1": rng.standard_normal((n - 1, 8)).astype(np.float32)
              * 0.3,
              "syn1neg": rng.standard_normal((n, 8)).astype(np.float32)
              * 0.3}
    codes, points, mask = Huffman.padded_arrays(model.cache)
    if not use_hs:
        mask = np.zeros_like(mask)
    centers = rng.randint(0, n, batch).astype(np.int32)
    contexts = rng.randint(0, n, batch).astype(np.int32)
    weights = np.ones(batch, np.float32)
    weights[-1] = 0.0
    neg_table = model.table.unigram_table()
    key = jax.random.PRNGKey(seed)
    slots = np.array(jax.random.randint(key, (batch, max(negative, 1)), 0,
                                        neg_table.shape[0]))
    return (tables, centers, contexts, codes, points, mask, neg_table, key,
            slots, weights)


@pytest.mark.parametrize("use_adagrad", [False, True])
@pytest.mark.parametrize("mode", ["hs_only", "negatives_only", "both"])
def test_one_step_matches_jax_w2v_step(mode, use_adagrad):
    negative = 0 if mode == "hs_only" else 3
    use_hs = mode != "negatives_only"
    (tables, centers, contexts, codes, points, mask, neg_table, key, slots,
     weights) = _step_inputs(negative, use_hs)
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    if use_adagrad:
        jt = jax_w2v_mod.add_adagrad_state(jt)
    c, x = jnp.asarray(centers), jnp.asarray(contexts)
    want, want_loss = _w2v_step_impl(
        jt, c, x, jnp.asarray(codes)[x], jnp.asarray(points)[x],
        jnp.asarray(mask)[x], jnp.asarray(neg_table), key, 0.05, negative,
        use_adagrad, weights=jnp.asarray(weights))

    ours = {k: torch.from_numpy(v.copy()) for k, v in tables.items()}
    if use_adagrad:
        add_adagrad_state(ours)
    tc, tx = torch.from_numpy(centers), torch.from_numpy(contexts)
    neg = (torch.from_numpy(neg_table)[torch.from_numpy(slots).long()]
           if negative else None)
    kernels.reset_launches()
    loss = w2v_step(ours, tc, tx, torch.from_numpy(codes)[tx],
                    torch.from_numpy(points)[tx], torch.from_numpy(mask)[tx],
                    neg, 0.05, use_adagrad, weights=torch.from_numpy(weights))
    assert kernels.LAUNCHES["scatter_add_rows"] == 0   # CPU: plain version
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=STEP_TOL)
    for k in SYN:
        _assert_tables_close(ours[k], want[k], STEP_TOL, k)
        if use_adagrad:
            _assert_tables_close(ours["h_" + k], want["h_" + k], STEP_TOL,
                                 "h_" + k)
    if not negative:   # syn1neg is not read: it stays as it was
        np.testing.assert_array_equal(ours["syn1neg"].numpy(),
                                      tables["syn1neg"])


def test_padded_pair_is_inert():
    # tests/test_embeddings.py:127-161 in the port: a weight-0 slot moves
    # no table row, so [pair, pad] and [pair, pair] with weights [1, 0] give
    # the same tables
    model = Word2Vec(vector_length=8, window=2, min_word_frequency=1, seed=0,
                     device="cpu")
    model.build_vocab([["a", "b", "c", "d"]])
    codes, points, mask = (torch.from_numpy(a) for a in
                           Huffman.padded_arrays(model.cache))
    neg_table = torch.from_numpy(model.table.unigram_table())
    slots = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(0), (2, 2), 0, neg_table.shape[0]))).long()

    def step(centers, contexts):
        tables = {k: getattr(model.table, k).clone() for k in SYN}
        c, x = torch.tensor(centers), torch.tensor(contexts)
        w2v_step(tables, c, x, codes[x], points[x], mask[x],
                 neg_table[slots], 0.05,
                 weights=torch.tensor([1.0, 0.0]))
        return tables

    out_pad, out_solo = step([0, 3], [1, 2]), step([0, 0], [1, 1])
    for k in SYN:
        np.testing.assert_allclose(out_pad[k].numpy(), out_solo[k].numpy(),
                                   rtol=1e-6, err_msg=f"padding leaked "
                                                      f"into {k}")


# ----------------------------------------------------------- whole fit

class NegativeReplay:
    """Records the negative slots the JAX package's fits draw (spies on
    `_w2v_epoch` and on paragraph vectors' `_w2v_step`, replaying their key
    schedule) and hands them, in order, to the port's
    `draw_negative_slots`."""

    def __init__(self, monkeypatch):
        self.slots = []
        self.used = 0
        real_epoch = jax_w2v_mod._w2v_epoch
        real_step = jax_pv_mod._w2v_step

        def epoch(*a, **kw):
            batch_idx, neg_table, key, negative = a[7], a[8], a[9], a[11]
            for _ in range(batch_idx.shape[0]):
                key, sub = jax.random.split(key)
                self._record(sub, batch_idx.shape[1], negative, neg_table)
            return real_epoch(*a, **kw)

        def step(*a, **kw):
            self._record(a[7], a[1].shape[0], a[9], a[6])
            return real_step(*a, **kw)

        def draw(generator, batch, negative, table_len, device):
            s = self.slots[self.used]
            self.used += 1
            assert s.shape == (batch, negative)
            return torch.from_numpy(s).long().to(device)

        monkeypatch.setattr(jax_w2v_mod, "_w2v_epoch", epoch)
        monkeypatch.setattr(jax_pv_mod, "_w2v_step", step)
        monkeypatch.setattr(w2v_mod, "draw_negative_slots", draw)

    def _record(self, key, batch, negative, neg_table):
        if negative > 0:
            self.slots.append(np.array(jax.random.randint(
                key, (batch, negative), 0, neg_table.shape[0])))


def _carried_pair(cls_jax, cls_port, sentences, **kw):
    """A JAX model and a port model (CPU) with the same vocabulary, the
    port's tables carried across from JAX's fresh ones."""
    ref, ours = cls_jax(**kw), cls_port(device="cpu", **kw)
    ref.build_vocab(TokenCorpus(sentences, ref.tokenize))
    ours.build_vocab(TokenCorpus(sentences, ours.tokenize))
    ours.table.load_numpy(**{k: np.asarray(getattr(ref.table, k))
                             for k in SYN
                             if getattr(ref.table, k) is not None})
    return ref, ours


W2V_FIT = dict(vector_length=12, window=3, min_word_frequency=1, negative=3,
               epochs=2, batch_size=96, seed=2)


@pytest.mark.parametrize("use_adagrad", [False, True])
def test_word2vec_fit_matches_jax_fit(monkeypatch, use_adagrad):
    sentences = _corpus(50)
    replay = NegativeReplay(monkeypatch)
    ref, ours = _carried_pair(JaxWord2Vec, Word2Vec, sentences,
                              use_adagrad=use_adagrad, **W2V_FIT)
    ref.fit(sentences)
    ours.fit(sentences)
    assert replay.used == len(replay.slots) > 2   # 2 epochs, padded tail
    for k in SYN:
        _assert_tables_close(getattr(ours.table, k), getattr(ref.table, k),
                             FIT_TOL, k)
    assert ours.words_nearest("cat", 3)[0][0] == ref.words_nearest(
        "cat", 3)[0][0]


def test_word2vec_fit_hs_only_without_negatives_matches_jax(monkeypatch):
    sentences = _corpus(30)
    replay = NegativeReplay(monkeypatch)
    kw = dict(W2V_FIT, negative=0)
    ref, ours = _carried_pair(JaxWord2Vec, Word2Vec, sentences, **kw)
    ref.fit(sentences)
    ours.fit(sentences)
    assert replay.used == 0
    for k in SYN:
        _assert_tables_close(getattr(ours.table, k), getattr(ref.table, k),
                             FIT_TOL, k)


def test_paragraph_vectors_fit_matches_jax(monkeypatch):
    docs = ["cat dog pet fur paw cat dog", "car truck road wheel engine",
            "dog pet paw fur cat pet", "truck car engine wheel road"]
    kw = dict(vector_length=12, window=3, min_word_frequency=1, negative=3,
              epochs=2, batch_size=16, seed=4, doc_epochs=3,
              labels=["an1", "ve1", "an2", "ve2"])
    replay = NegativeReplay(monkeypatch)
    ref, ours = _carried_pair(JaxParagraphVectors, ParagraphVectors, docs,
                              **kw)
    ref.fit(docs)
    # JAX's doc table starts from its seed + 1 key (paragraph_vectors.py:52)
    doc0 = (jax.random.uniform(jax.random.PRNGKey(4 + 1), (4, 12)) - 0.5) / 12
    ours.fit(docs, doc_vectors=np.asarray(doc0))
    assert replay.used == len(replay.slots)
    _assert_tables_close(ours.doc_vectors, ref.doc_vectors, FIT_TOL, "doc")
    _assert_tables_close(ours.table.syn0, ref.table.syn0, FIT_TOL, "syn0")
    # JAX's doc phase donates the word phase's syn1 and syn1neg to its jitted
    # step, which deletes them (ROADMAP queue C); the port's doc phase works
    # on copies and leaves them as the word phase left them
    assert ref.table.syn1.is_deleted()
    assert ours.table.syn1.abs().max() > 0
    assert ours.nearest_docs("an1", 1)[0][0] == ref.nearest_docs("an1", 1)[0][0]


def test_glove_fit_matches_jax(monkeypatch):
    sentences = _corpus(40)
    kw = dict(vector_length=8, window=5, min_word_frequency=1, epochs=3,
              batch_size=32, seed=1)
    ref = JaxGlove(**kw).fit(sentences)
    # JAX's starting tables (glove.py:112-120)
    n = ref.cache.num_words()
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    scale = 0.5 / 8
    init = {"w": jax.random.uniform(k1, (n, 8), minval=-scale, maxval=scale),
            "wt": jax.random.uniform(k2, (n, 8), minval=-scale,
                                     maxval=scale),
            "b": np.zeros(n, np.float32), "bt": np.zeros(n, np.float32)}
    ours = Glove(device="cpu", **kw)
    kernels.reset_launches()
    ours.fit(sentences, init={k: np.asarray(v) for k, v in init.items()})
    assert ours.cache.words() == ref.cache.words()
    assert kernels.LAUNCHES["scatter_add_rows"] == 0
    _assert_tables_close(ours.table.syn0, ref.table.syn0, FIT_TOL, "syn0")
    assert set(ours.params) == {"w", "wt", "b", "bt"}
    assert ours.params["b"].shape == (n,)


def test_summed_batch_sgd_blows_up_alike_in_both_packages(monkeypatch):
    # the loss is summed over the batch, so a row that many pairs share in a
    # step (the Huffman root, the zipf head) moves by alpha times that many
    # gradients: at a large batch both packages' tables grow without bound
    # (NaN at the bench's size, ROADMAP queue C). Here a zipf corpus as
    # bench.py's at vocab 300, 8000 tokens and batch 2048 grows syn0 from
    # 0.5 / 32 to about 1.3e3 in one epoch, in both; the tolerance is 1e-2
    # because the growth amplifies the steps' rounding differences.
    rng = np.random.RandomState(0)
    freq = 1.0 / np.arange(1, 301)
    tokens = rng.choice(300, size=8000, p=freq / freq.sum())
    words = np.array([f"w{i}" for i in range(300)])
    sentences = [list(words[tokens[i:i + 20]]) for i in range(0, 8000, 20)]
    replay = NegativeReplay(monkeypatch)
    ref, ours = _carried_pair(JaxWord2Vec, Word2Vec, sentences,
                              vector_length=32, window=5, negative=5,
                              min_word_frequency=1, epochs=1, seed=0,
                              batch_size=2048)
    ref.fit(sentences)
    ours.fit(sentences)
    assert replay.used == len(replay.slots)
    for k in SYN:
        assert float(np.abs(np.asarray(getattr(ref.table, k))).max()) > 1e3
        _assert_tables_close(getattr(ours.table, k), getattr(ref.table, k),
                             1e-2, k)


def test_two_cpu_fits_give_bitwise_equal_tables():
    # the plain scatter adds each row's updates in the order of n on every
    # run, so a CPU fit repeats bit for bit on four threads, at a batch
    # whose scatters pass 32,768 float32 elements (where index_put_ with
    # accumulate would add with parallel atomics): the summed-batch test
    # above compares two such fits with JAX
    rng = np.random.RandomState(0)
    freq = 1.0 / np.arange(1, 301)
    tokens = rng.choice(300, size=8000, p=freq / freq.sum())
    words = np.array([f"w{i}" for i in range(300)])
    sentences = [list(words[tokens[i:i + 20]]) for i in range(0, 8000, 20)]
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        tables = []
        for _ in range(2):
            model = Word2Vec(vector_length=32, window=5, negative=5,
                             min_word_frequency=1, epochs=1, seed=0,
                             batch_size=2048, device="cpu")
            model.fit(sentences)
            tables.append({k: getattr(model.table, k).clone() for k in SYN})
    finally:
        torch.set_num_threads(threads)
    for k in SYN:
        assert torch.equal(tables[0][k], tables[1][k]), k


def test_glove_cooccurrences_and_one_step_match_jax():
    import deeplearning4j_tpu.models.glove as jax_glove_mod

    from deeplearning4j_tpu_torch.models import glove as glove_mod

    ids = [[0, 1, 2, 1, 3], [2, 2, 4, 0], [1]]
    ours, ref = glove_mod.CoOccurrences(3), jax_glove_mod.CoOccurrences(3)
    for sent in ids:
        ours.add_sentence(sent)
        ref.add_sentence(sent)
    for a, b in zip(ours.arrays(), ref.arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    wi, wj, x = ref.arrays()
    rng = np.random.RandomState(31)
    params = {"w": rng.standard_normal((5, 6)).astype(np.float32),
              "wt": rng.standard_normal((5, 6)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "bt": rng.standard_normal(5).astype(np.float32)}
    logx = np.log(x)
    fx = np.minimum(1.0, (x / 2.0) ** 0.75).astype(np.float32)
    state = {"params": {k: jnp.asarray(v) for k, v in params.items()},
             "hist": {k: jnp.zeros(v.shape) for k, v in params.items()}}
    want, want_loss = jax_glove_mod._glove_step(
        state, *(jnp.asarray(a) for a in (wi, wj, logx, fx)),
        jnp.asarray(0.05, jnp.float32))
    got = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    hist = {k: torch.zeros_like(v) for k, v in got.items()}
    loss = glove_mod.glove_step(got, hist, *(torch.from_numpy(a) for a in
                                             (wi, wj, logx, fx)),
                                torch.tensor(0.05))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=STEP_TOL)
    for k in glove_mod.PARAM_KEYS:
        _assert_tables_close(got[k], want["params"][k], STEP_TOL, k)
        _assert_tables_close(hist[k], want["hist"][k], STEP_TOL, "h_" + k)


def test_queries_match_jax_on_the_same_table():
    ours, ref = _trained_pair(seed=6)
    for w in ("cat", "truck"):
        got, want = ours.words_nearest(w, top=5), ref.words_nearest(w, top=5)
        assert [g[0] for g in got] == [r[0] for r in want]
        np.testing.assert_allclose([g[1] for g in got], [r[1] for r in want],
                                   rtol=1e-5, atol=1e-6)
    assert ours.similarity("cat", "dog") == pytest.approx(
        ref.similarity("cat", "dog"), rel=1e-6)
    assert ([a for a, _ in ours.analogy("cat", "dog", "car", top=3)]
            == [a for a, _ in ref.analogy("cat", "dog", "car", top=3)])
    assert ours.vector("absent") is None and ours.words_nearest("absent") == []
    assert np.isnan(ours.similarity("cat", "absent"))


# ------------------------------------------- behaviour with the port's RNG

def test_word2vec_trains_and_clusters():
    w2v = Word2Vec(vector_length=24, window=4, min_word_frequency=1,
                   negative=4, epochs=4, batch_size=256, seed=1, device="cpu")
    w2v.fit(_corpus())
    assert w2v.vector("cat").shape == (24,)
    same = w2v.similarity("cat", "dog")
    cross = w2v.similarity("cat", "truck")
    assert same > cross, (same, cross)
    near = [w for w, _ in w2v.words_nearest("cat", top=4)]
    assert any(w in ("dog", "pet", "fur", "paw") for w in near)
    assert isinstance(w2v.analogy("cat", "dog", "car", top=3), list)


def test_word2vec_hs_only():
    w2v = Word2Vec(vector_length=16, window=3, min_word_frequency=1,
                   negative=0, use_hierarchical_softmax=True, epochs=3,
                   batch_size=128, seed=2, device="cpu")
    w2v.fit(_corpus(120))
    assert w2v.similarity("car", "truck") > w2v.similarity("car", "dog")


def test_word2vec_adagrad_changes_trajectory_and_converges():
    kw = dict(vector_length=16, window=3, min_word_frequency=1, negative=3,
              epochs=3, batch_size=128, seed=2, device="cpu")
    sgd = Word2Vec(**kw).fit(_corpus(120))
    ada = Word2Vec(use_adagrad=True, **kw).fit(_corpus(120))
    assert not np.allclose(sgd.table.syn0.numpy(), ada.table.syn0.numpy())
    assert ada.similarity("car", "truck") > ada.similarity("car", "dog")


def test_glove_trains_and_clusters():
    g = Glove(vector_length=16, window=5, min_word_frequency=1, epochs=20,
              seed=1, device="cpu")
    g.fit(_corpus(150))
    assert g.similarity("cat", "dog") > g.similarity("cat", "engine")


def test_paragraph_vectors():
    docs = ["cat dog pet fur paw cat dog", "car truck road wheel engine",
            "dog pet paw fur cat pet", "truck car engine wheel road"]
    pv = ParagraphVectors(vector_length=16, window=3, min_word_frequency=1,
                          negative=3, epochs=8, batch_size=64, seed=4,
                          labels=["an1", "ve1", "an2", "ve2"], device="cpu")
    pv.fit(docs)
    assert pv.doc_vector("an1").shape == (16,)
    assert pv.doc_similarity("an1", "an2") > pv.doc_similarity("an1", "ve1")
    assert pv.doc_vector("nope") is None


def test_tables_start_seeded_with_the_reference_shapes():
    a = Word2Vec(vector_length=6, min_word_frequency=1, seed=9, device="cpu")
    b = Word2Vec(vector_length=6, min_word_frequency=1, seed=9, device="cpu")
    for m in (a, b):
        m.build_vocab([["x", "y", "z", "x"]])
    np.testing.assert_array_equal(a.table.syn0.numpy(), b.table.syn0.numpy())
    assert float(a.table.syn0.abs().max()) <= 0.5 / 6
    assert a.table.syn1.shape == (2, 6) and a.table.syn1neg.shape == (3, 6)
    assert not a.table.syn1.any() and not a.table.syn1neg.any()
    with pytest.raises(ValueError, match="shape"):
        a.table.load_numpy(syn1=np.zeros((3, 6)))


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Word2Vec, Glove, ParagraphVectors):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make(device="cpu").device.type == "cpu"


# --------------------------------------------- serialization across packages

def _trained_pair(seed=3):
    """The same trained vectors in a JAX table and a port table."""
    w2v = Word2Vec(vector_length=8, min_word_frequency=1, epochs=1,
                   batch_size=64, seed=seed, device="cpu").fit(_corpus(40))
    ref = jax_emb.InMemoryLookupTable(w2v.cache, 8, seed)
    ref.syn0 = jnp.asarray(w2v.table.syn0.numpy())
    return w2v.table, ref


def test_word_vector_files_are_byte_identical_to_jax(tmp_path):
    ours, ref = _trained_pair()
    for writer, jax_writer, name in (
            (embeddings.write_word_vectors, jax_emb.write_word_vectors,
             "v.txt"),
            (embeddings.write_word_vectors_binary,
             jax_emb.write_word_vectors_binary, "v.bin")):
        writer(ours, str(tmp_path / f"port_{name}"))
        jax_writer(ref, str(tmp_path / f"jax_{name}"))
        assert ((tmp_path / f"port_{name}").read_bytes()
                == (tmp_path / f"jax_{name}").read_bytes())


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_word_vector_files_cross_packages(tmp_path, fmt):
    ours, ref = _trained_pair(seed=5)
    suffix = "" if fmt == "text" else "_binary"
    port_w, port_r = (getattr(embeddings, f"write_word_vectors{suffix}"),
                      getattr(embeddings, f"read_word_vectors{suffix}"))
    jax_w, jax_r = (getattr(jax_emb, f"write_word_vectors{suffix}"),
                    getattr(jax_emb, f"read_word_vectors{suffix}"))
    # the text format keeps 6 significant digits; binary is exact
    tol = dict(rtol=1e-5, atol=1e-7) if fmt == "text" else dict(rtol=0,
                                                                 atol=0)
    port_w(ours, str(tmp_path / "from_port"))
    by_jax = jax_r(str(tmp_path / "from_port"))
    jax_w(ref, str(tmp_path / "from_jax"))
    by_port = port_r(str(tmp_path / "from_jax"), device="cpu")
    assert sorted(by_jax.cache.words()) == sorted(ours.cache.words())
    assert by_port.cache.words() == by_jax.cache.words()
    for w in ours.cache.words():
        np.testing.assert_allclose(by_jax.vector(w), ours.vector(w), **tol)
        np.testing.assert_allclose(by_port.vector(w), ref.vector(w), **tol)
    assert (by_port.words_nearest("cat", top=2)[0][0]
            == by_jax.words_nearest("cat", top=2)[0][0])


def test_binary_reader_handles_multibyte_words(tmp_path):
    cache = embeddings.VocabCache()
    cache.fit([["café", "naïve", "中文"]])
    table = embeddings.InMemoryLookupTable(cache, 4, seed=1, device="cpu")
    path = str(tmp_path / "mb.bin")
    embeddings.write_word_vectors_binary(table, path)
    loaded = embeddings.read_word_vectors_binary(path, device="cpu")
    for w in ("café", "naïve", "中文"):
        np.testing.assert_array_equal(loaded.vector(w), table.vector(w))


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_cuda_word2vec_fit_launches_the_scatter_kernel_per_gather():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    w2v = Word2Vec(vector_length=16, window=3, min_word_frequency=1,
                   negative=3, epochs=2, batch_size=128, seed=2)
    sentences = _corpus(60)
    w2v.build_vocab(TokenCorpus(sentences, w2v.tokenize))
    kernels.reset_launches()
    w2v.fit(sentences)
    torch.cuda.synchronize()
    steps = kernels.LAUNCHES["scatter_add_rows"] // 3
    assert steps > 0 and kernels.LAUNCHES["scatter_add_rows"] == 3 * steps
    assert w2v.similarity("car", "truck") > w2v.similarity("car", "dog")

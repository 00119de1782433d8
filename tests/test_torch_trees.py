"""The port's tree models and tree parser against the JAX package's.

`models/rntn.py`, `rntn_eval.py`, `recursive_autoencoder.py` and
`text/tree_parser.py` on the CPU, on the same trees: parsing, planning
and every parser strategy give equal trees; the initial params (and the
rows a later `fit` grows) are bitwise JAX's threefry draws; the first
step's loss and gradients are within 1e-5. AdaGrad's history starts at
1e-8, so its first update is about lr * sign(g) for every element, even
where g is rounding noise: after k steps the params are compared only
where the first gradient is well above that noise, and the trained
models are held to the JAX package's own accuracy and reconstruction
criteria (tests/test_rntn.py, test_tree_parser.py, test_char_lstm_rae.py,
test_embeddings.py), with per-node argmaxes equal to JAX's from one state
(`state_from_numpy`). The captured AdaGrad step is held to the eager one
on the card (cuda marker).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.models import recursive_autoencoder as jax_rae  # noqa: E402,E501
from deeplearning4j_tpu.models import rntn as jax_rntn  # noqa: E402
from deeplearning4j_tpu.models.rntn_eval import RNTNEval as JaxRNTNEval  # noqa: E402,E501
from deeplearning4j_tpu.text import tree_parser as jax_tree_parser  # noqa: E402,E501
from deeplearning4j_tpu.text.sentiment_lexicon import (  # noqa: E402
    SentimentLexicon as JaxLexicon)
from deeplearning4j_tpu_torch.models import recursive_autoencoder as rae  # noqa: E402,E501
from deeplearning4j_tpu_torch.models import rntn  # noqa: E402
from deeplearning4j_tpu_torch.models.rntn_eval import RNTNEval  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.text.sentiment_lexicon import (  # noqa: E402
    SentimentLexicon)
from deeplearning4j_tpu_torch.text.tree_parser import TreeParser  # noqa: E402

POS = ["(1 (1 good) (1 great))",
       "(1 (1 (1 nice) (1 fine)) (1 good))",
       "(1 (1 happy) (1 (1 good) (1 great)))"]
NEG = ["(0 (0 bad) (0 awful))",
       "(0 (0 (0 poor) (0 bad)) (0 awful))",
       "(0 (0 sad) (0 (0 bad) (0 poor)))"]
WORDS = ["good", "great", "nice", "bad", "awful", "poor", "the", "movie",
         "a", "plot", "was", "not", "very", "dull", "fun"]


def sexpr(t) -> str:
    """A tree of either package as an s-expression."""
    if t.is_leaf:
        return f"({t.label} {t.word})"
    return f"({t.label} {sexpr(t.left)} {sexpr(t.right)})"


def random_trees(n, seed=0, classes=5, lo=1, hi=9, unsupervised=0.0):
    """n random binary trees over WORDS as s-expressions, labels drawn from
    a seed (some -1 with probability `unsupervised`)."""
    rng = np.random.RandomState(seed)

    def label():
        return -1 if rng.rand() < unsupervised else rng.randint(classes)

    def build(toks):
        if len(toks) == 1:
            return f"({label()} {toks[0]})"
        k = rng.randint(1, len(toks))
        return f"({label()} {build(toks[:k])} {build(toks[k:])})"

    return [build(list(rng.choice(WORDS, size=rng.randint(lo, hi))))
            for _ in range(n)]


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _grads_within(got, want, tol=1e-5):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


# ------------------------------------------------------ parsing and plans

def test_parse_and_plan_equal_jax():
    trees = POS + NEG + random_trees(20, seed=1) + [
        "(2 (3 word))", "(3 (2 the) (4 (3 very) (4 good)))",
        "(1 (2 (0 (1 a))) (1 b))"]
    vocab = {"<unk>": 0, **{w: i + 1 for i, w in enumerate(WORDS[:8])}}
    ours, ref = [], []
    for s in trees:
        t, j = rntn.parse_tree(s), jax_rntn.parse_tree(s)
        assert sexpr(t) == sexpr(j)
        assert rntn.tree_tokens(t) == jax_rntn.tree_tokens(j)
        p, q = rntn.plan_tree(t, vocab, 20), jax_rntn.plan_tree(j, vocab, 20)
        assert p.n_nodes == q.n_nodes
        for k in rntn.PLAN_KEYS:
            np.testing.assert_array_equal(getattr(p, k), getattr(q, k))
        ours.append(p)
        ref.append(q)
    stacked = rntn.stack_plans(ours, device="cpu")
    jstacked = jax_rntn.stack_plans(ref)
    for k in rntn.PLAN_KEYS:
        np.testing.assert_array_equal(stacked[k].numpy(),
                                      np.asarray(jstacked[k]))
    with pytest.raises(ValueError, match="max_nodes"):
        rntn.plan_tree(rntn.parse_tree(POS[0]), vocab, 2)


def _parsers(strategy, **kw):
    lex = kw.pop("lexicon", None)
    ours = TreeParser(strategy, device="cpu",
                      lexicon=SentimentLexicon() if lex else None, **kw)
    ref = jax_tree_parser.TreeParser(
        strategy, lexicon=JaxLexicon() if lex else None, **kw)
    return ours, ref


PARSE_SENTENCES = [
    "the quick fox jumps over the lazy dog",
    "a small bird sleeps in the old tree",
    "the movie was not good", "the of and", "solo", "   ",
    "the broken gate ruined a beautiful garden",
    "some farmers sold sweet apples at the market",
    "she can open the can and he will book a room quickly",
    "the teacher explained the lesson clearly but the students were bored"]


@pytest.mark.parametrize("strategy", ["right", "left", "balanced", "chunk"])
@pytest.mark.parametrize("kw", [
    {}, {"lexicon": True}, {"lexicon": True, "n_classes": 3},
    {"lexicon": True, "neutral_label": 0}, {"neutral_label": 2},
    {"label_fn": len}], ids=["plain", "lexicon", "lexicon3", "neutral0",
                             "neutral2", "label_fn"])
def test_parser_trees_equal_jax(strategy, kw):
    ours, ref = _parsers(strategy, **kw)
    for s in PARSE_SENTENCES:
        t, j = ours.parse(s), ref.parse(s)
        assert (t is None) == (j is None)
        if t is not None:
            assert sexpr(t) == sexpr(j), (strategy, s)
    assert [sexpr(t) for t in ours.get_trees(PARSE_SENTENCES)] == \
        [sexpr(t) for t in ref.get_trees(PARSE_SENTENCES)]


def test_parser_rejects_unknown_strategy_and_loads_its_tagger_lazily():
    with pytest.raises(ValueError, match="strategy"):
        TreeParser("bogus", device="cpu")
    balanced = TreeParser("balanced")  # no device: never touches one
    assert balanced.parse("a b c") is not None and balanced._tagger is None
    chunk = TreeParser("chunk", device="cpu")
    chunk.parse("the dog runs")
    assert chunk.tagger.device.type == "cpu"


def test_chunk_strategy_meets_jax_gold_criteria():
    """tests/test_tree_parser.py's gold-bracket recall with the port's
    parser (its tagger on the CPU)."""
    gold = [
        ("the quick fox jumps over the lazy dog", {(0, 3), (4, 8), (5, 8)}),
        ("a small bird sleeps in the old tree", {(0, 3), (3, 8), (4, 8)}),
        ("the teacher explained the lesson clearly", {(0, 2), (3, 5)}),
        ("some farmers sold sweet apples at the market",
         {(0, 2), (3, 5), (5, 8), (6, 8)}),
        ("the cold wind blows from the north", {(0, 3), (4, 7), (5, 7)}),
        ("she bought three red tomatoes", {(2, 5)}),
        ("the children play in the park daily", {(0, 2), (3, 6), (4, 6)}),
        ("a strange man walks quickly", {(0, 3)})]

    def spans(t):
        out = set()

        def rec(n, s):
            if n.is_leaf:
                return s + 1
            e = rec(n.right, rec(n.left, s))
            out.add((s, e))
            return e

        rec(t, 0)
        return out

    def recall(strategy):
        parser = TreeParser(strategy, device="cpu")
        hit = tot = 0
        for sent, g in gold:
            hit += len(g & spans(parser.parse(sent)))
            tot += len(g)
        return hit / tot

    chunk, balanced, right = (recall(s) for s in ("chunk", "balanced",
                                                  "right"))
    assert chunk >= 0.9 and chunk > balanced and chunk > right
    assert balanced <= 0.5 and right <= 0.5


# ------------------------------------------------------------ init draws

@pytest.mark.parametrize("seed, vocab, dim, classes",
                         [(0, 10, 8, 2), (3, 37, 25, 5)])
def test_init_params_are_jax_draws_bitwise(seed, vocab, dim, classes):
    got = rntn.init_rntn_params(nd_random.prng_key(seed), vocab, dim,
                                classes)
    want = jax_rntn.init_rntn_params(jax.random.PRNGKey(seed), vocab, dim,
                                     classes)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got = rae.init_rae_params(nd_random.prng_key(seed), vocab, dim)
    want = jax_rae.init_rae_params(jax.random.PRNGKey(seed), vocab, dim)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("kind", ["rntn", "rae"])
def test_fit_draws_and_grows_the_vocabulary_as_jax(kind):
    if kind == "rntn":
        ours = rntn.RNTN(dim=6, n_classes=2, max_nodes=16, seed=4,
                         device="cpu")
        ref = jax_rntn.RNTN(dim=6, n_classes=2, max_nodes=16, seed=4)
    else:
        ours = rae.RecursiveAutoEncoder(dim=6, max_nodes=16, seed=4,
                                        device="cpu")
        ref = jax_rae.RecursiveAutoEncoder(dim=6, max_nodes=16, seed=4)
    assert ours.fit(POS, epochs=0) == ref.fit(POS, epochs=0) == float("inf")
    for k, v in _np(ref.params).items():
        np.testing.assert_array_equal(ours.params[k].numpy(), v)
    ours.fit(NEG, epochs=0)
    ref.fit(NEG, epochs=0)
    assert ours.vocab == ref.vocab and len(ours.vocab) == 10
    np.testing.assert_array_equal(ours.params["E"].numpy(),
                                  np.asarray(ref.params["E"]))
    np.testing.assert_array_equal(ours._hist["E"].numpy(),
                                  np.asarray(ref._hist["E"]))


# --------------------------------------------------------- losses, grads

def _jax_state(model, trees, epochs):
    model.fit(trees, epochs=epochs)
    return _np(model.params), _np(model._hist)


@pytest.mark.parametrize("seed, l2", [(0, 1e-4), (5, 0.0), (9, 1e-2)])
def test_rntn_loss_and_grads_equal_jax(seed, l2):
    trees = random_trees(12, seed=seed, unsupervised=0.2)
    ref = jax_rntn.RNTN(dim=7, n_classes=5, max_nodes=24, seed=seed)
    params, _ = _jax_state(ref, trees, epochs=seed % 3)
    jplans = ref._plans([jax_rntn.parse_tree(t) for t in trees])
    loss, grads = jax.value_and_grad(jax_rntn.rntn_loss)(ref.params, jplans,
                                                         l2)
    ours = rntn.RNTN(dim=7, n_classes=5, max_nodes=24, device="cpu")
    ours.vocab = dict(ref.vocab)
    p, _ = rntn.state_from_numpy(params, device="cpu")
    ps = {k: v.requires_grad_() for k, v in p.items()}
    got = rntn.rntn_loss(ps, ours._plans(trees), l2)
    assert abs(float(got) - float(loss)) <= 1e-5
    names = sorted(ps)
    g = torch.autograd.grad(got, [ps[k] for k in names])
    _grads_within({k: v.numpy() for k, v in zip(names, g)}, _np(grads))


@pytest.mark.parametrize("seed, l2", [(1, 1e-4), (2, 0.0)])
def test_rae_loss_and_grads_equal_jax(seed, l2):
    trees = random_trees(10, seed=seed)
    ref = jax_rae.RecursiveAutoEncoder(dim=6, max_nodes=20, seed=seed)
    params, _ = _jax_state(ref, trees, epochs=seed)
    jplans = jax_rntn.stack_plans([jax_rntn.plan_tree(
        jax_rntn.parse_tree(t), ref.vocab, 20) for t in trees])
    loss, grads = jax.value_and_grad(jax_rae.rae_loss)(ref.params, jplans, l2)
    ours = rae.RecursiveAutoEncoder(dim=6, max_nodes=20, device="cpu")
    ours.vocab = dict(ref.vocab)
    p, _ = rntn.state_from_numpy(params, device="cpu")
    ps = {k: v.requires_grad_() for k, v in p.items()}
    got = rae.rae_loss(ps, ours._plans(trees), l2)
    assert abs(float(got) - float(loss)) <= 1e-5
    names = sorted(ps)
    g = torch.autograd.grad(got, [ps[k] for k in names])
    _grads_within({k: v.numpy() for k, v in zip(names, g)}, _np(grads))


def test_tree_scan_gradients_are_exact_in_float64():
    """TreeScan's backward (recomputed steps, the node-gradient buffer)
    against finite differences of its forward, in float64, for both
    cells."""
    trees = random_trees(4, seed=3, lo=2, hi=6)
    model = rntn.RNTN(dim=3, n_classes=2, max_nodes=12, device="cpu")
    model._prepare(trees)
    plans = model._plans(trees)
    gen = torch.Generator().manual_seed(0)

    def draw(*shape):
        return (torch.rand(shape, generator=gen, dtype=torch.float64)
                - 0.5).requires_grad_()

    leaf = draw(4, 12, 3)
    for cell, params in ((rntn._rntn_cell, (draw(6, 3), draw(3),
                                            draw(3, 6, 6))),
                         (rae._rae_cell, (draw(6, 3), draw(3), draw(3, 6),
                                          draw(6)))):
        def loss(leaf, *params):
            nodes, err = rntn.TreeScan.apply(
                cell, leaf, plans["left"], plans["right"],
                plans["is_leaf"], *params)
            return (nodes ** 3).sum() + (err * 0.7).sum()

        assert torch.autograd.gradcheck(loss, (leaf,) + params, eps=1e-6,
                                        atol=1e-6)


@pytest.mark.parametrize("kind", ["rntn", "rae"])
def test_first_step_and_trained_params_follow_jax(kind):
    """One AdaGrad step from JAX's state lands within 1e-5 of JAX's params
    wherever the gradient is above rounding noise; after 8 more steps the
    params stay within 1e-4 there."""
    trees = random_trees(16, seed=11)
    if kind == "rntn":
        ref = jax_rntn.RNTN(dim=6, n_classes=5, max_nodes=20, lr=0.05,
                            seed=2)
        ours = rntn.RNTN(dim=6, n_classes=5, max_nodes=20, lr=0.05, seed=2,
                         device="cpu")
        loss_fn = jax_rntn.rntn_loss
    else:
        ref = jax_rae.RecursiveAutoEncoder(dim=6, max_nodes=20, lr=0.05,
                                           seed=2)
        ours = rae.RecursiveAutoEncoder(dim=6, max_nodes=20, lr=0.05,
                                        seed=2, device="cpu")
        loss_fn = jax_rae.rae_loss
    ref.fit(trees, epochs=0)
    jplans = jax_rntn.stack_plans([jax_rntn.plan_tree(
        jax_rntn.parse_tree(t), ref.vocab, 20) for t in trees])
    _, g0 = jax.value_and_grad(loss_fn)(ref.params, jplans, 1e-4)
    # above noise: well clear of float32 rounding of the largest entry
    live = {k: np.abs(np.asarray(v)) > 1e-3 * np.abs(np.asarray(v)).max()
            for k, v in g0.items()}
    assert ours.fit(trees, epochs=0) == float("inf")
    for epochs, tol in ((1, 1e-5), (8, 1e-4)):
        want = ref.fit(trees, epochs=epochs)
        got = ours.fit(trees, epochs=epochs)
        assert abs(got - want) <= tol * max(1.0, abs(want))
        for k, v in _np(ref.params).items():
            np.testing.assert_allclose(ours.params[k].numpy()[live[k]],
                                       v[live[k]], atol=tol, err_msg=k)


# ------------------------------------------- JAX's criteria on the port

def test_rntn_learns_tiny_sentiment_as_jax_requires():
    model = rntn.RNTN(dim=8, n_classes=2, max_nodes=16, lr=0.1, seed=0,
                      device="cpu")
    loss = model.fit(POS + NEG, epochs=150)
    assert np.isfinite(loss)
    assert model.accuracy(POS + NEG, root_only=True) == 1.0
    assert model.accuracy(POS + NEG, root_only=False) > 0.9
    other = rntn.RNTN(dim=8, n_classes=2, max_nodes=16, lr=0.1, seed=1,
                      device="cpu")
    other.fit(POS + NEG, epochs=150)
    root_pred, node_preds = other.predict("(1 (1 great) (1 happy))")
    assert root_pred == 1 and len(node_preds) == 3
    grow = rntn.RNTN(dim=8, n_classes=2, max_nodes=16, lr=0.1, seed=0,
                     device="cpu")
    grow.fit(POS, epochs=20)
    n0 = grow.params["E"].shape[0]
    grow.fit(NEG, epochs=20)
    assert grow.params["E"].shape[0] == len(grow.vocab) > n0
    assert grow._hist["E"].shape == grow.params["E"].shape


def test_predictions_and_eval_equal_jax_from_one_state():
    """From one trained state, the port's per-tree `predict`, its batched
    `accuracy` and its `RNTNEval` give JAX's per-node argmaxes."""
    trees = random_trees(16, seed=6, unsupervised=0.1)
    ref = jax_rntn.RNTN(dim=8, n_classes=5, max_nodes=20, lr=0.1, seed=3)
    ref.fit(trees, epochs=40)
    ours = rntn.RNTN(dim=8, n_classes=5, max_nodes=20, device="cpu")
    ours.vocab = dict(ref.vocab)
    ours.params, ours._hist = rntn.state_from_numpy(
        _np(ref.params), _np(ref._hist), device="cpu")
    held_out = random_trees(3, seed=7) + ["(1 (1 zzz) (0 good))"]
    for t in trees[:3] + held_out:
        r, n = ours.predict(t)
        jr, jn = ref.predict(t)
        assert r == jr
        np.testing.assert_array_equal(n, jn)
    for root_only in (True, False):
        assert ours.accuracy(held_out, root_only) == \
            ref.accuracy(held_out, root_only)
    ev, jev = RNTNEval(), JaxRNTNEval()
    ev.eval(ours, held_out)
    jev.eval(ref, [jax_rntn.parse_tree(t) for t in held_out])
    np.testing.assert_array_equal(ev.evaluation.confusion.to_array(),
                                  jev.evaluation.confusion.to_array())
    assert ev.accuracy() == jev.accuracy() and ev.f1() == jev.f1()
    assert ev.stats() == jev.stats()
    # the batch forward answers as a tree at a time
    batched = ours._predict_plans(trees)
    for t, (plan, preds) in zip(trees, batched):
        np.testing.assert_array_equal(preds, ours.predict(t)[1])
    assert ours.accuracy([]) == 0.0


def test_rntn_eval_counts_as_jax_requires():
    pos = rntn.TreeNode(label=1, left=rntn.TreeNode(label=1, word="good"),
                        right=rntn.TreeNode(label=1, word="great"))
    neg = rntn.TreeNode(label=0, left=rntn.TreeNode(label=0, word="bad"),
                        right=rntn.TreeNode(label=0, word="awful"))
    model = rntn.RNTN(dim=6, n_classes=2, max_nodes=8, lr=0.1, seed=0,
                      device="cpu")
    model.fit([pos, neg], epochs=150)
    ev = RNTNEval()
    ev.eval(model, [pos, neg])
    assert ev.evaluation.confusion.total() == 2
    assert ev.accuracy() >= 0.5
    assert "accuracy" in ev.stats().lower()


def test_unsupervised_nodes_are_masked_as_jax_requires():
    leaf_a = rntn.TreeNode(label=1, word="good")
    leaf_b = rntn.TreeNode(label=-1, word="the")
    t = rntn.TreeNode(label=1, left=leaf_b, right=leaf_a)
    model = rntn.RNTN(dim=4, n_classes=2, max_nodes=8, seed=0, device="cpu")
    model.fit([t], epochs=1)
    with torch.no_grad():
        loss = rntn.rntn_loss(model.params, model._plans([t]))
        assert np.isfinite(float(loss))
        t0 = rntn.TreeNode(label=-1, left=rntn.TreeNode(label=-1, word="a"),
                           right=rntn.TreeNode(label=-1, word="b"))
        assert float(rntn.rntn_loss(model.params, model._plans([t0]),
                                    l2=0.0)) == 0.0


def test_parser_fed_rntn_meets_jax_criteria():
    """tests/test_tree_parser.py's training criteria on the port."""
    pos_words = {"good", "great", "nice", "happy"}
    parser = TreeParser("balanced", device="cpu",
                        label_fn=lambda tok: int(tok in pos_words))
    trees = parser.get_trees(["good great", "nice good happy",
                              "great happy"]) + parser.get_trees(
        ["bad awful", "poor bad sad", "awful sad"])
    model = rntn.RNTN(dim=8, n_classes=2, max_nodes=16, lr=0.1, seed=0,
                      device="cpu")
    model.fit(trees, epochs=120)
    assert model.accuracy(trees, root_only=True) >= 5 / 6

    lex = SentimentLexicon()
    adjs = ["beautiful", "sweet", "good", "strong",
            "broken", "cold", "rough", "strange"]
    nouns = ["garden", "tree", "house", "movie", "music", "game"]
    tpls = ["the {n} was {a}", "a {a} {n}", "the {n} seems very {a}",
            "the {n} of the {n2} was {a}"]
    sents = [tpl.format(a=a, n=nouns[(ti + ai) % 6],
                        n2=nouns[(ti + ai + 1) % 6])
             for ti, tpl in enumerate(tpls) for ai, a in enumerate(adjs)]
    accs = {}
    for strategy in ("chunk", "balanced"):
        trees = TreeParser(strategy, lexicon=lex,
                           device="cpu").get_trees(sents)
        model = rntn.RNTN(dim=8, n_classes=2, max_nodes=16, lr=0.1, seed=0,
                          device="cpu")
        model.fit(trees, epochs=60)
        accs[strategy] = model.accuracy(trees, root_only=True)
    assert accs["chunk"] >= 0.9 and accs["chunk"] >= accs["balanced"]


def test_rae_meets_jax_criteria_and_encodes_as_jax():
    trees = ["(0 (0 a) (0 b))", "(0 (0 (0 a) (0 b)) (0 c))",
             "(0 (0 c) (0 (0 a) (0 d)))"]
    model = rae.RecursiveAutoEncoder(dim=8, max_nodes=16, lr=0.1, seed=0,
                                     device="cpu")
    loss_first = model.fit(trees, epochs=1)
    loss_last = model.fit(trees, epochs=150)
    assert loss_last < loss_first * 0.5, (loss_first, loss_last)
    small = rae.RecursiveAutoEncoder(dim=8, max_nodes=8, lr=0.1, seed=1,
                                     device="cpu")
    small.fit(["(0 (0 a) (0 b))", "(0 (0 b) (0 c))"], epochs=100)
    vec = small.encode("(0 (0 a) (0 b))")
    assert vec.shape == (8,) and np.isfinite(vec).all()
    err = small.reconstruction_error("(0 (0 a) (0 b))")
    assert np.isfinite(err) and err >= 0
    # from one state, encode and reconstruction_error are JAX's
    ref = jax_rae.RecursiveAutoEncoder(dim=8, max_nodes=16, lr=0.1, seed=5)
    ref.fit(trees, epochs=0)
    ours = rae.RecursiveAutoEncoder(dim=8, max_nodes=16, device="cpu")
    ours.vocab = dict(ref.vocab)
    ours.params, ours._hist = rntn.state_from_numpy(
        _np(ref.params), _np(ref._hist), device="cpu")
    for t in trees[1:] + ["(0 (0 zz) (0 (0 a) (0 c)))", "(0 a)"]:
        np.testing.assert_allclose(ours.encode(t), ref.encode(t),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ours.reconstruction_error(t),
                                   ref.reconstruction_error(t),
                                   rtol=1e-5, atol=1e-7)


def test_the_step_is_one_cached_program_a_key():
    model = rntn.RNTN(dim=4, n_classes=2, max_nodes=8, seed=0, device="cpu")
    model.fit(POS, epochs=3)
    stats = model.step_cache.stats
    assert (stats.misses, stats.hits, stats.steps) == (1, 2, 3)
    model.fit(POS, epochs=2)  # same batch, vocabulary and shapes: hits
    assert (stats.misses, stats.hits) == (1, 4)
    model.fit(NEG, epochs=1)  # the vocabulary grew: a new key
    assert stats.misses == 2 and len(model.step_cache) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rntn", "rae"])
def test_captured_step_equals_eager_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trees = random_trees(64, seed=12, lo=2, hi=20)
    def make(capture):
        model = (rntn.RNTN(dim=25, n_classes=5, max_nodes=40, seed=1,
                           device="cuda") if kind == "rntn" else
                 rae.RecursiveAutoEncoder(dim=25, max_nodes=40, seed=1,
                                          device="cuda"))
        model.step_cache.capture = capture
        return model

    captured, eager = make(True), make(False)
    losses = [m.fit(trees, epochs=3) for m in (captured, eager)]
    # the scatter kernel adds in any order: equal to float32 rounding
    assert abs(losses[0] - losses[1]) <= 1e-5 * max(1.0, abs(losses[1]))
    for k in eager.params:
        torch.testing.assert_close(captured.params[k], eager.params[k],
                                   rtol=1e-4, atol=1e-5)
    assert captured.step_cache.stats.misses == 1

"""The port's PoS tagging, Viterbi decoder and sentiment lexicon against
the JAX package's.

`utils/viterbi.py` runs the JAX package's two `lax.scan`s (max-product
forward, backtrack) as loops on the decoder's device; on numpy-seeded
log-probabilities the paths are equal and the best log-probabilities
within 1e-6, ties included (both argmaxes take the first maximum). The
bundled HMM tagger (a byte-equal copy of `pos_model.json`), the rule
tagger, the PoS filter, the tagged corpus and its retraining, and the
SentiWordNet-style lexicon (a byte-equal copy of `sentiment_lexicon.tsv`)
answer as JAX's do. Entry points take `device="cpu"` here; without it
they want a card.
"""

import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.text import hmm_pos as jax_hmm  # noqa: E402
from deeplearning4j_tpu.text import pos as jax_pos  # noqa: E402
from deeplearning4j_tpu.text import pos_tagged_corpus as jax_corpus  # noqa: E402,E501
from deeplearning4j_tpu.text import sentiment_lexicon as jax_lex  # noqa: E402,E501
from deeplearning4j_tpu.text.tokenization import (  # noqa: E402
    DefaultTokenizerFactory as JaxFactory)
from deeplearning4j_tpu.utils import viterbi as jax_viterbi  # noqa: E402
from deeplearning4j_tpu_torch.text import hmm_pos, pos  # noqa: E402
from deeplearning4j_tpu_torch.text import pos_tagged_corpus  # noqa: E402
from deeplearning4j_tpu_torch.text import sentiment_lexicon  # noqa: E402
from deeplearning4j_tpu_torch.text.tokenization import (  # noqa: E402
    DefaultTokenizerFactory)
from deeplearning4j_tpu_torch.utils import viterbi  # noqa: E402

SENTENCES = [
    "she can open the can", "he will book a room", "i read the book",
    "the plants grow quickly", "she plants trees every year",
    "the old man walks to the market", "they train new workers daily",
    "Five strange birds sang beautifully in 2024",
    "the quick brown fox jumps over the lazy dog",
    "unbelievably the xylophones were tunefully reharmonized",
    "a", "the teacher explained the lesson clearly"]


def _data(name):
    return os.path.join("text", "data", name)


@pytest.mark.parametrize("name", ["pos_model.json", "sentiment_lexicon.tsv"])
def test_bundled_data_files_are_byte_equal_copies(name):
    import deeplearning4j_tpu
    import deeplearning4j_tpu_torch

    digests = []
    for pkg in (deeplearning4j_tpu, deeplearning4j_tpu_torch):
        path = os.path.join(os.path.dirname(pkg.__file__), _data(name))
        with open(path, "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    assert digests[0] == digests[1]


def _random_case(t, s, seed, ties=False):
    rng = np.random.RandomState(seed)
    if ties:
        # few distinct values: equal scores at every max and argmax
        draw = lambda *shape: np.log(rng.randint(1, 4, size=shape) / 4.0)  # noqa: E731,E501
    else:
        draw = lambda *shape: np.log(rng.dirichlet(np.ones(shape[-1]),  # noqa: E731,E501
                                                   size=shape[:-1] or None))
    return draw(s), draw(s, s), draw(t, s)


@pytest.mark.parametrize("t, s, seed, ties", [
    (1, 4, 0, False), (2, 3, 1, False), (7, 5, 2, False),
    (40, 12, 3, False), (64, 45, 4, False), (9, 4, 5, True),
    (30, 6, 6, True), (3, 1, 7, False)])
def test_viterbi_paths_equal_jax(t, s, seed, ties):
    init, trans, obs = _random_case(t, s, seed, ties)
    got_path, got_best = viterbi.Viterbi(s, init, trans, device="cpu") \
        .decode(obs)
    want_path, want_best = jax_viterbi.Viterbi(s, init, trans).decode(obs)
    np.testing.assert_array_equal(got_path, want_path)
    assert got_path.dtype == np.int64 and got_path.shape == (t,)
    assert abs(got_best - want_best) <= 1e-6
    probs = np.exp(obs)
    gp, gb = viterbi.Viterbi(s, init, trans, device="cpu") \
        .decode_from_probs(probs)
    wp, wb = jax_viterbi.Viterbi(s, init, trans).decode_from_probs(probs)
    np.testing.assert_array_equal(gp, wp)
    assert abs(gb - wb) <= 1e-6


def test_viterbi_ties_take_the_first_state():
    # every path scores alike: both decoders choose state 0 throughout
    s, t = 4, 6
    flat = viterbi.Viterbi(s, device="cpu")
    path, best = flat.decode(np.zeros((t, s)))
    want, wbest = jax_viterbi.Viterbi(s).decode(np.zeros((t, s)))
    np.testing.assert_array_equal(path, np.zeros(t, np.int64))
    np.testing.assert_array_equal(path, want)
    assert best == wbest == 0.0
    # a tie between states 1 and 3 at the end, and between predecessors
    trans = np.log(np.full((s, s), 0.25))
    obs = np.log(np.array([[0.1, 0.4, 0.1, 0.4]] * t))
    got, _ = viterbi.Viterbi(s, np.zeros(s), trans, device="cpu").decode(obs)
    want, _ = jax_viterbi.Viterbi(s, np.zeros(s), trans).decode(obs)
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {1}


def test_viterbi_decode_stays_on_its_device():
    init, trans, obs = _random_case(5, 3, 9)
    v = viterbi.Viterbi(3, init, trans, device="cpu")
    assert v.log_init.dtype == torch.float32 and v.log_init.device.type == \
        "cpu"
    path, best = viterbi.viterbi_decode(
        v.log_init, v.log_trans, torch.as_tensor(obs, dtype=torch.float32))
    assert path.dtype == torch.int64 and best.dim() == 0
    np.testing.assert_array_equal(path.numpy(), v.decode(obs)[0])


def test_entry_points_want_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    for make in (lambda: viterbi.Viterbi(3),
                 lambda: hmm_pos.HmmPosTagger(),
                 lambda: hmm_pos.bundled_tagger()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.fixture(scope="module")
def taggers():
    return hmm_pos.bundled_tagger(device="cpu"), jax_hmm.bundled_tagger()


def test_hmm_tags_equal_jax(taggers):
    ours, ref = taggers
    assert ours.tags == ref.tags
    factory = DefaultTokenizerFactory()
    for s in SENTENCES:
        toks = factory.create(s).get_tokens()
        assert ours.tag(toks) == ref.tag(toks), s
        np.testing.assert_array_equal(ours._obs_logprobs(toks),
                                      ref._obs_logprobs(toks))
    assert ours.tag([]) == ref.tag([]) == []
    assert ours.tag_word("plants") == ref.tag_word("plants")
    # context: "can" as MD then NN, as the JAX tagger tags it
    assert ours.tag("she can open the can".split())[1::3] == ["MD", "NN"]


def test_hmm_training_equals_jax(tmp_path):
    sents = pos_tagged_corpus.tagged_sentences()
    assert sents == jax_corpus.tagged_sentences()
    for smoothing in (1.0, 0.2):
        ours = hmm_pos.HmmPosTagger(device="cpu").train(sents, smoothing)
        ref = jax_hmm.HmmPosTagger().train(sents, smoothing)
        got, want = ours.to_dict(), ref.to_dict()
        assert got.keys() == want.keys() and got["tags"] == want["tags"]
        for k in ("log_init", "log_trans"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("log_emit", "log_emit_suffix"):
            assert got[k].keys() == want[k].keys()
            for w in want[k]:
                np.testing.assert_array_equal(got[k][w], want[k][w])
        ours.save(str(tmp_path / "m.json"))
        back = hmm_pos.HmmPosTagger.load(str(tmp_path / "m.json"),
                                          device="cpu")
        toks = "the plants need water".split()
        assert back.tag(toks) == ours.tag(toks) == ref.tag(toks)


def test_corpus_main_rewrites_the_bundled_model_byte_for_byte(
        tmp_path, monkeypatch, capsys):
    out = tmp_path / "pos_model.json"
    monkeypatch.setattr(hmm_pos, "_BUNDLED", str(out))
    pos_tagged_corpus.main()
    assert "tags" in capsys.readouterr().out
    with open(jax_hmm._BUNDLED, "rb") as f:
        want = f.read()
    assert out.read_bytes() == want
    assert json.loads(want)["tags"] == hmm_pos.bundled_tagger(
        device="cpu").tags


def test_rule_tagger_and_filter_equal_jax(taggers):
    toks = ("The 3 quick dogs were running happily because Paris is "
            "beautiful and 4.5 nations could sleep").split()
    assert pos.PosTagger().tag(toks) == jax_pos.PosTagger().tag(toks)
    for w in toks + ["creation", "glass", "walked"]:
        assert pos.PosTagger().tag_word(w, "NN") == \
            jax_pos.PosTagger().tag_word(w, "NN")
    allowed = {"NN", "NNS", "JJ"}
    ours = pos.PosFilterTokenizerFactory(DefaultTokenizerFactory(), allowed,
                                         device="cpu")
    ref = jax_pos.PosFilterTokenizerFactory(JaxFactory(), allowed)
    assert isinstance(ours.tagger, hmm_pos.HmmPosTagger)
    for s in SENTENCES:
        assert ours.tokenize(s) == ref.tokenize(s)
        assert ours.create(s).get_tokens() == ref.create(s).get_tokens()
    rules = pos.PosFilterTokenizerFactory(DefaultTokenizerFactory(), allowed,
                                          tagger=pos.PosTagger())
    jrules = jax_pos.PosFilterTokenizerFactory(JaxFactory(), allowed,
                                               tagger=jax_pos.PosTagger())
    assert rules.tokenize(SENTENCES[5]) == jrules.tokenize(SENTENCES[5])


def test_lexicon_equals_jax(tmp_path):
    ours, ref = sentiment_lexicon.SentimentLexicon(), \
        jax_lex.SentimentLexicon()
    assert ours.scores == ref.scores and ours.pos_scores == ref.pos_scores
    assert len(ours.scores) > 300
    words = sorted(ref.scores)[::7] + ["unknownword", "NOT", "Good"]
    for w in words:
        assert ours.score(w) == ref.score(w)
        for n in (2, 3):
            assert ours.label(w, n) == ref.label(w, n)
            assert ours.label_fn(n)(w) == ref.label_fn(n)(w)
    for toks in (["good", "movie"], ["not", "good"], ["bad", "not", "bad"],
                 ["didn't", "love", "it"], []):
        assert ours.score_tokens(toks) == ref.score_tokens(toks)
    for s in (-1.0, -0.75, -0.5, -0.25, -0.1, 0.0, 0.05, 0.25, 0.6, 0.75):
        assert ours.class_for_score(s) == ref.class_for_score(s)
        for n, neutral in ((2, None), (2, -1), (3, None), (3, -1)):
            assert ours.label_for_score(s, n, neutral) == \
                ref.label_for_score(s, n, neutral)
    assert sentiment_lexicon.NEGATION_WORDS == jax_lex.NEGATION_WORDS
    custom = {"meh": 0.1, "yay": 0.9}
    assert sentiment_lexicon.SentimentLexicon(custom).scores == \
        jax_lex.SentimentLexicon(custom).scores
    path = tmp_path / "swn.tsv"
    path.write_text("# comment\n"
                    "a\t1\t0.5\t0.125\tgood#1 fine#2\tgloss\n"
                    "a\t2\t0.25\t0\tgood#2\n"
                    "n\t3\t0\t0.5\tbad#1 bad#x\n"
                    "v\t4\t\t\tskip#1\n"
                    "r\t5\t0.5\t0\tzero#0 plain\n")
    got = sentiment_lexicon.SentimentLexicon.from_sentiwordnet(str(path))
    want = jax_lex.SentimentLexicon.from_sentiwordnet(str(path))
    assert got.pos_scores == want.pos_scores and got.scores == want.scores

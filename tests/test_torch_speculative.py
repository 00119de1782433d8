"""The port's speculative decoding against the JAX package's.

At small widths (vocab 13; `char_lstm(13, hidden=16, n_layers=2)`,
`char_transformer(13, d_model=32, n_blocks=2, n_heads=2)`), with JAX's
params carried across and inputs from numpy seeds, in f32 on the CPU:
the attention layer's `verify_chunk`/`verify_chunk_paged` (hidden rows and
caches within 1e-5), `nn/decode.verify_chunk`/`verify_chunk_paged` (logp,
state and carry stacks within 1e-5, and the port's verify against K
one-token `decode_step`s within 1e-6), the infer cache's `verify` and
`verify_paged` (sampled tokens and keys bitwise JAX's, greedy and at 0.9;
the rolled-back state within 1e-5), `_accepted_len` and the in-program
rollback on drafts that agree none, some and all of the time, and the
`ContinuousBatcher` with a disagreeing draft (`char_lstm(13, hidden=8)`
from another seed) and a cloned one: its streams are the JAX batcher's and
the port's one-step pass's, dense, paged, with the prefix cache (exact and
longest match) and with every option at once, and `stats()["speculative"]`
is the JAX batcher's. Then `warmup_generate` with a draft, the JAX
package's errors for bad options, and failed draft and verify captures,
which end their streams with no fallback. On the CPU the programs run
eagerly with the keys and books of the CUDA path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import decode as jax_decode  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.nn.layers.attention import \
    MultiHeadAttentionLayer as JaxAttention  # noqa: E402
from deeplearning4j_tpu.optimize import infer_cache as jax_ic  # noqa: E402
from deeplearning4j_tpu.serving.batcher import ContinuousBatcher as JaxBatcher  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn import decode  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.layers.attention import \
    MultiHeadAttentionLayer  # noqa: E402
from deeplearning4j_tpu_torch.optimize import infer_cache  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402
from deeplearning4j_tpu_torch.serving import ContinuousBatcher  # noqa: E402
from deeplearning4j_tpu_torch.serving.batcher import (  # noqa: E402
    ACCEPTED_TOKENS_BOUNDS, decode_geometry)

VOCAB = 13
MODELS = ["lstm", "transformer"]
K = 3
#: streams of the batcher runs (stream i seeded i): more than the two slots,
#: so a slot is freed and taken again mid-run
PROMPTS = ([1, 2, 3, 4], [5, 6, 7], [2, 9])


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _jax_conf(model):
    if model == "lstm":
        return jax_zoo.char_lstm(VOCAB, hidden=16, n_layers=2)
    if model == "draft":
        return jax_zoo.char_lstm(VOCAB, hidden=8, n_layers=1)
    return jax_zoo.char_transformer(VOCAB, d_model=32, n_blocks=2, n_heads=2,
                                    max_seq_len=32)


def _carry(jconf, seed):
    """A JAX net from `seed` and the port's net on its params."""
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=seed).init()
    tnet = ml.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu")
    tnet.params = checkpoint.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), "cpu")
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net) by name: the two targets, a disagreeing draft
    (another width and seed) and a clone of the char-LSTM target (its conf
    and params: every greedy proposal is accepted)."""
    out = {m: _carry(_jax_conf(m), 0) for m in MODELS}
    out["draft"] = _carry(_jax_conf("draft"), 1)
    out["clone"] = _carry(_jax_conf("lstm"), 0)
    return out


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _trees_close(got, want, tol=1e-5):
    jl = jax.tree_util.tree_leaves(want)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, tol)


def _copy(state):
    return tuple({k: v.clone() for k, v in lay.items()} for lay in state)


# -- the attention layer ---------------------------------------------------------

def _attention_case(paged):
    """A 2-row chunk of K tokens over random caches (dense [2, 16, 32], or a
    pool of 9 pages of 4 with a page table), rows at positions 3 and 9."""
    from deeplearning4j_tpu.nn.layers.attention import \
        MultiHeadAttentionLayer as JA

    jconf = _jax_conf("transformer").conf(1)
    params = JA.init(jax.random.PRNGKey(3), jconf)
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, K, 32)).astype(np.float32)
    shape = (9, 4, 32) if paged else (2, 16, 32)
    kc, vc = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    pos = np.asarray([3, 9], np.int32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    return jconf, params, x, kc, vc, pos, table


@pytest.mark.parametrize("paged", [False, True])
def test_attention_verify_chunk_matches_jax(paged):
    jconf, params, x, kc, vc, pos, table = _attention_case(paged)
    tconf = MultiLayerConfiguration.from_json(
        _jax_conf("transformer").to_json()).conf(1)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    targs = [torch.from_numpy(a.copy()) for a in (x, kc, vc, pos)]
    jargs = [jnp.asarray(a) for a in (x, kc, vc, pos)]
    if paged:
        want = JaxAttention.verify_chunk_paged(params, jconf, *jargs,
                                               jnp.asarray(table))
        with torch.no_grad():
            got = MultiHeadAttentionLayer.verify_chunk_paged(
                tparams, tconf, *targs, torch.from_numpy(table))
    else:
        want = JaxAttention.verify_chunk(params, jconf, *jargs)
        with torch.no_grad():
            got = MultiHeadAttentionLayer.verify_chunk(tparams, tconf,
                                                       *targs)
    for g, w in zip(got, want):
        _close(g, w)
    # the caches were written in place
    assert got[1] is targs[1] and got[2] is targs[2]


# -- nn/decode.py -------------------------------------------------------------

def _prefilled(jnet, tnet, paged):
    """Both packages' states for two rows after prefills of lengths 5 and
    3 (dense table 16, or a pool of 9 pages of 4 and the rows' page
    tables), with the prefill's positions as `pos`."""
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, VOCAB, (2, 8)).astype(np.int32)
    length = np.asarray([5, 3], np.int32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    js = jax_decode.init_state(jnet.conf, 2, 16)
    _, js = jax_decode.prefill(jnet.conf, jnet.params, js,
                               jnp.asarray(prompt), jnp.asarray(length))
    ts = decode.init_state(tnet.conf, 2, 16, "cpu")
    with torch.no_grad():
        _, ts = decode.prefill(tnet.conf, tnet.params, ts,
                               torch.from_numpy(prompt),
                               torch.from_numpy(length))
    ts = _copy(ts)
    if paged:
        # each row's 16 positions in its own 4 pages of the pool
        def pool(state, init, put):
            out = []
            for lay, p in zip(state, init):
                if "k" in lay:
                    out.append({n: put(p[n], lay[n]) for n in ("k", "v")})
                else:
                    out.append(lay)
            return tuple(out)

        jpool = jax_decode.init_paged_state(jnet.conf, 2, 9, 4)
        js = pool(js, jpool, lambda p, d: p.at[table.reshape(-1)].set(
            d.reshape(8, 4, -1)))
        tpool = decode.init_paged_state(tnet.conf, 2, 9, 4, "cpu")
        ts = pool(ts, tpool, lambda p, d: p.index_copy(
            0, torch.from_numpy(table.reshape(-1)).long(),
            d.reshape(8, 4, -1)))
    return js, ts, length, table


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_verify_chunk_matches_jax_and_k_steps(nets, model, paged):
    jnet, tnet = nets[model]
    js, ts, pos, table = _prefilled(jnet, tnet, paged)
    toks = np.random.RandomState(1).randint(0, VOCAB, (2, K)).astype(
        np.int32)
    extra = (table,) if paged else ()
    jfn = jax_decode.verify_chunk_paged if paged else jax_decode.verify_chunk
    tfn = decode.verify_chunk_paged if paged else decode.verify_chunk
    wl, ws, wc = jfn(jnet.conf, jnet.params, js, jnp.asarray(toks),
                     jnp.asarray(pos), *(jnp.asarray(a) for a in extra))
    with torch.no_grad():
        gl, gs, gc = tfn(tnet.conf, tnet.params, _copy(ts),
                         torch.from_numpy(toks), torch.from_numpy(pos),
                         *(torch.from_numpy(a) for a in extra))
    assert tuple(gl.shape) == (2, K, VOCAB)
    _close(gl, wl)
    _trees_close(gs, ws)
    _trees_close(gc, wc)
    # K one-token steps of the port on a copy of the same state
    st, rows = _copy(ts), []
    step = decode.decode_step_paged if paged else decode.decode_step
    with torch.no_grad():
        for i in range(K):
            lp, st = step(tnet.conf, tnet.params, st,
                          torch.from_numpy(toks[:, i]),
                          torch.from_numpy(pos + i),
                          *(torch.from_numpy(a) for a in extra))
            rows.append(lp)
    _close(torch.stack(rows, dim=1), gl.numpy(), 1e-6)
    _trees_close(st, [{k: v.numpy() for k, v in lay.items()} for lay in gs],
                 1e-6)


# -- the infer cache's verify -----------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("paged", [False, True])
def test_infer_cache_verify_matches_jax(nets, model, temperature, paged):
    jnet, tnet = nets[model]
    js, ts, pos, table = _prefilled(jnet, tnet, paged)
    toks = np.random.RandomState(2).randint(0, VOCAB, (2, K)).astype(
        np.int32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (5, 6)])
    temps = np.asarray([temperature, 0.0], np.float32)
    jic, tic = jnet.infer_cache, tnet.infer_cache
    if paged:
        want = jic.verify_paged(jnet.conf, jnet.params, js,
                                jnp.asarray(toks), jnp.asarray(pos),
                                jnp.asarray(keys), jnp.asarray(temps),
                                jnp.asarray(table))
        got = tic.verify_paged(tnet.conf, tnet.params, ts, toks, pos, keys,
                               temps, table)
    else:
        want = jic.verify(jnet.conf, jnet.params, js, jnp.asarray(toks),
                          jnp.asarray(pos), jnp.asarray(keys),
                          jnp.asarray(temps))
        got = tic.verify(tnet.conf, tnet.params, ts, toks, pos, keys, temps)
    assert got[0].dtype == torch.int32 and tuple(got[0].shape) == (2, K)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1]).astype(np.int64))
    assert got[2] is ts  # written in place
    _trees_close(got[2], want[2])


@pytest.mark.parametrize("agree", ["none", "some", "all"])
def test_in_program_rollback_is_the_hosts_accepted_depth(nets, agree):
    """Proposals built from the greedy samples themselves, so that a row
    agrees for none, one or all of its K - 1 proposals: the accepted depth
    of `_accepted_len` is the host's loop's (and JAX's), and the char-LSTM
    target's carries after the verify are those after e one-token steps."""
    _, tnet = nets["lstm"]
    _, ts, pos, _ = _prefilled(*nets["lstm"], paged=False)
    ic = tnet.infer_cache
    keys = np.zeros((2, 2), np.uint32)
    temps = np.zeros((2,), np.float32)
    # the greedy continuation of each row: one-token decodes
    st, cur, greedy = _copy(ts), np.asarray([4, 7], np.int32), []
    for i in range(K):
        t, _, st = ic.decode(tnet.conf, tnet.params, st, cur, pos + i, keys,
                             temps)
        greedy.append(t.numpy())
        cur = t.numpy()
    greedy = np.stack(greedy, axis=1)
    n_agree = {"none": 0, "some": 1, "all": K - 1}[agree]
    toks = np.zeros((2, K), np.int32)
    toks[:, 0] = [4, 7]
    for j in range(1, K):
        toks[:, j] = (greedy[:, j - 1] if j <= n_agree
                      else (greedy[:, j - 1] + 1) % VOCAB)
    sampled, _, state = ic.verify(tnet.conf, tnet.params, _copy(ts), toks,
                                  pos, keys, temps)
    # the samples up to the first disagreement are the greedy tokens (the
    # later ones are conditioned on rejected proposals)
    np.testing.assert_array_equal(sampled.numpy()[:, :n_agree + 1],
                                  greedy[:, :n_agree + 1])
    e_prog = infer_cache._accepted_len(torch.from_numpy(toks), sampled)
    e_jax = jax_ic._accepted_len(jnp.asarray(toks), jnp.asarray(
        sampled.numpy()))
    for row in range(2):
        e = 1
        while e < K and toks[row, e] == sampled[row, e - 1]:
            e += 1
        assert int(e_prog[row]) == int(e_jax[row]) == e == n_agree + 1
    # the carries after e one-token steps of the proposals
    st = _copy(ts)
    for i in range(n_agree + 1):
        _, _, st = ic.decode(tnet.conf, tnet.params, st, toks[:, i],
                             pos + i, keys, temps)
    for a, b in zip(tree_leaves(state), tree_leaves(st)):
        if a.dim() == 2:  # the (h, c) carries; K/V rows are not compared
            _close(a, b.numpy(), 1e-6)


def test_accepted_len_k1_and_mixed_rows():
    toks = torch.tensor([[3, 1, 2, 5], [3, 9, 9, 9], [0, 4, 4, 4]])
    sampled = torch.tensor([[1, 2, 5, 7], [8, 9, 9, 9], [4, 4, 4, 4]])
    e = infer_cache._accepted_len(toks, sampled)
    assert e.tolist() == [4, 1, 4]
    want = jax_ic._accepted_len(jnp.asarray(toks.numpy()),
                                jnp.asarray(sampled.numpy()))
    assert e.tolist() == np.asarray(want).tolist()
    assert infer_cache._accepted_len(toks[:, :1], sampled[:, :1]).tolist() \
        == [1, 1, 1]


def test_verify_programs_key_as_jax(nets):
    _, tnet = nets["transformer"]
    net = ml.MultiLayerNetwork(tnet.conf, device="cpu")
    net.params = tnet.params
    ic = net.infer_cache
    state = ic.init_decode_state(net.conf, 2, 16, "cpu")
    args = (np.zeros((2, K), np.int32), np.zeros((2,), np.int32),
            np.zeros((2, 2), np.uint32), np.zeros((2,), np.float32))
    ic.verify(net.conf, net.params, state, *args, compile_only=True)
    pool = ic.init_paged_decode_state(net.conf, 2, 9, 4, "cpu")
    ic.verify_paged(net.conf, net.params, pool, *args,
                    np.zeros((2, 4), np.int32), compile_only=True)
    assert [r["entry"] for r in ic.programs_summary()] == ["verify",
                                                           "verify-paged"]
    assert ic.stats.misses == 2 and ic.stats.steps == 0


# -- the batcher ------------------------------------------------------------------

def _serve(cls, net, n_new, temperature, draft=None, prompts=PROMPTS,
           **kw):
    """Every prompt through a 2-slot batcher of `cls` over a 16-token table
    (stream i seeded i), all queued before it starts: each stream's tokens,
    and the stats once the loop has stopped."""
    if draft is not None:
        kw.update(draft_net=draft, spec_k=K)
    cb = cls(net, n_slots=2, max_seq=16, prompt_buckets=(8,),
             auto_start=False, **kw)
    try:
        streams = [cb.submit(list(p), max_new_tokens=n_new,
                             temperature=temperature, rng_seed=i)
                   for i, p in enumerate(prompts)]
        cb.start()
        toks = [list(s.tokens(timeout=60.0)) for s in streams]
    finally:
        cb.stop()
    return toks, cb.stats()


#: (target, draft): a disagreeing draft for both targets, the clone for the
#: char-LSTM (a draft has no attention, so the charTransformer has none)
PAIRS = [("lstm", "draft"), ("lstm", "clone"), ("transformer", "draft")]
#: the batcher's layouts: dense, the paged pool, the prefix cache (a second
#: copy of a prompt is an exact hit, an extension of one a longest match)
LAYOUTS = {"dense": {}, "paged": {"page_size": 4},
           "prefix_exact": {"prefix_cache": True},
           "prefix_longest": {"prefix_cache": True,
                              "prefix_match": "longest"},
           "all": {"page_size": 4, "n_pages": 6, "prefix_cache": True,
                   "prefix_match": "longest"}}
PREFIX_PROMPTS = ([1, 2, 3], [1, 2, 3], [1, 2, 3, 4, 5], [7])


@pytest.mark.parametrize("target,draft", PAIRS)
@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batcher_streams_equal_the_jax_batchers(nets, target, draft,
                                                temperature, layout):
    (jnet, tnet), (jd, td) = nets[target], nets[draft]
    kw = LAYOUTS[layout]
    prompts = PROMPTS if layout in ("dense", "paged") else PREFIX_PROMPTS
    want, jst = _serve(JaxBatcher, jnet, 8, temperature, jd, prompts, **kw)
    got, st = _serve(ContinuousBatcher, tnet, 8, temperature, td, prompts,
                     **kw)
    plain, _ = _serve(ContinuousBatcher, tnet, 8, temperature, None,
                      prompts, **kw)
    assert got == want == plain
    assert st["speculative"] == jst["speculative"]
    assert st["streams"] == jst["streams"] == {
        "admitted": len(prompts), "completed": len(prompts), "failed": 0}
    assert st["steps_per_dispatch"] == 1
    if "prefix_cache" in kw:
        assert st["prefix_cache"] == jst["prefix_cache"]
        assert st["prefix_cache"]["hits"] >= 1
    if "page_size" in kw:
        assert st["kv_pages"]["live"] == 0


def test_cloned_draft_accepts_whole_chunks(nets):
    """The clone proposes the target's own greedy tokens: every round
    accepts K, so far fewer rounds than tokens."""
    (jnet, tnet), (jd, td) = nets["lstm"], nets["clone"]
    got, st = _serve(ContinuousBatcher, tnet, 9, 0.0, td, ([1, 2, 3],))
    want, _ = _serve(JaxBatcher, jnet, 9, 0.0, jd, ([1, 2, 3],))
    assert got == want
    spec = st["speculative"]
    assert spec["accepted_per_step"] > 1.0
    assert spec["rounds"] < 8 and spec["accepted_hist"]["counts"][2] > 0


def test_speculative_stats_keys_are_the_jax_batchers(nets):
    (jnet, tnet), (jd, td) = nets["lstm"], nets["draft"]
    _, jst = _serve(JaxBatcher, jnet, 6, 0.0, jd)
    _, st = _serve(ContinuousBatcher, tnet, 6, 0.0, td)
    assert set(st) == set(jst)
    assert set(st["speculative"]) == set(jst["speculative"]) == {
        "k", "rounds", "accepted_per_step", "accepted_hist"}
    assert st["speculative"]["accepted_hist"]["bounds"] == list(
        ACCEPTED_TOKENS_BOUNDS)
    assert st["speculative"]["k"] == K
    assert st["speculative"]["rounds"] >= 1
    # every round was speculative here: the tokens after each stream's
    # first (its prefill's) are the accepted ones
    assert st["decode_block_steps"]["count"] == 0
    assert st["speculative"]["accepted_hist"]["sum"] == st["tokens"] - len(
        PROMPTS)
    _, plain = _serve(ContinuousBatcher, tnet, 6, 0.0)
    assert "speculative" not in plain


def test_table_edge_and_feed_rounds_keep_the_draft_in_lockstep(nets):
    """Streams that reach the table's edge (no room for K more) and longest
    matches that feed prompt tokens decode one step at a time with the
    draft stepping beside them; their tokens stay the JAX batcher's."""
    (jnet, tnet), (jd, td) = nets["transformer"], nets["draft"]
    prompts = ([1, 2, 3, 4, 5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8], [9])
    kw = {"prefix_cache": True, "prefix_match": "longest"}
    want, jst = _serve(JaxBatcher, jnet, 16, 0.9, jd, prompts, **kw)
    got, st = _serve(ContinuousBatcher, tnet, 16, 0.9, td, prompts, **kw)
    assert got == want
    assert [len(t) for t in got] == [9, 8, 15]  # clamped to the table
    assert st["speculative"] == jst["speculative"]
    assert st["decode_block_steps"]["count"] > 0  # one-step rounds ran


# -- options, warm-up and faults ---------------------------------------------------

@pytest.mark.parametrize("case", ["spec_k_1", "attention_draft",
                                  "explicit_k", "draft_bound"])
def test_bad_speculative_options_raise_the_jax_errors(nets, case):
    (jnet, tnet), (jd, td) = nets["lstm"], nets["draft"]
    kw = {"spec_k_1": dict(spec_k=1),
          "attention_draft": dict(spec_k=2),
          "explicit_k": dict(spec_k=3, steps_per_dispatch=4),
          "draft_bound": dict(spec_k=2)}[case]
    jdraft, tdraft = jd, td
    if case == "attention_draft":
        jdraft, tdraft = nets["transformer"]
    if case == "draft_bound":
        jdraft, tdraft = _carry(_bounded_lstm(), 2)
    with pytest.raises(ValueError) as want:
        JaxBatcher(jnet, n_slots=1, max_seq=16, prompt_buckets=(8,),
                   draft_net=jdraft, auto_start=False, **kw)
    with pytest.raises(ValueError) as got:
        ContinuousBatcher(tnet, n_slots=1, max_seq=16, prompt_buckets=(8,),
                          draft_net=tdraft, auto_start=False, **kw)
    assert str(got.value) == str(want.value)


def _bounded_lstm():
    """A recurrent draft whose embedding has an 8-row positional table."""
    conf = jax_zoo.char_lstm(VOCAB, hidden=8, n_layers=1, embed=8)
    return conf.replace(confs=(conf.confs[0].replace(max_seq_len=8),)
                        + conf.confs[1:])


def test_spec_k_without_a_draft_is_zero_as_in_jax(nets):
    jnet, tnet = nets["lstm"]
    jcb = JaxBatcher(jnet, n_slots=1, max_seq=16, spec_k=3,
                     auto_start=False)
    cb = ContinuousBatcher(tnet, n_slots=1, max_seq=16, spec_k=3,
                           auto_start=False)
    assert cb.spec_k == jcb.spec_k == 0
    assert decode_geometry(1, 16, spec_k=3)["spec_k"] == 0


def test_a_draft_of_another_vocabulary_is_refused(nets):
    _, tnet = nets["lstm"]
    _, big = _carry(jax_zoo.char_lstm(VOCAB + 3, hidden=8), 1)
    with pytest.raises(ValueError, match="vocabulary"):
        ContinuousBatcher(tnet, n_slots=1, max_seq=16, draft_net=big,
                          spec_k=2, auto_start=False)


@pytest.mark.parametrize("options", [{}, {"page_size": 4,
                                          "prefix_cache": True}],
                         ids=["dense", "paged-prefix"])
def test_warmup_generate_with_a_draft_leaves_nothing_to_capture(options):
    """Warm-up captures the verify, the draft's one-step decode and its
    prefill per bucket, on the states the batcher decodes in; the JAX
    package's warm-up makes the same programs; serving makes none."""
    jnet, tnet = _carry(_jax_conf("transformer"), 3)
    jd, td = _carry(_jax_conf("draft"), 4)
    want = jnet.warmup_generate(slots=2, max_seq=16, prompt_buckets=(4, 8),
                                draft_net=jd, spec_k=K, **options)
    got = tnet.warmup_generate(slots=2, max_seq=16, prompt_buckets=(4, 8),
                               draft_net=td, spec_k=K, **options)
    for key in ("slots", "max_seq", "prompt_buckets", "page_size",
                "prefix_cache", "spec_k", "steps_per_dispatch"):
        assert got[key] == want[key]
    for t, j in ((tnet, jnet), (td, jd)):
        assert sorted(r["entry"] for r in t.infer_cache.programs_summary()) \
            == sorted(r["entry"] for r in j.infer_cache.programs_summary())
    warmed = tnet.infer_cache.stats.misses + td.infer_cache.stats.misses
    toks, st = _serve(ContinuousBatcher, tnet, 10, 0.9, td,
                      ([1, 2], [3, 4, 5, 6, 7], [1, 2]), **options)
    assert [len(t) for t in toks] == [10, 10, 10]
    assert st["fresh_compiles"] == warmed
    assert st["speculative"]["rounds"] > 0


@pytest.mark.parametrize("failing", ["draft_decode", "verify"])
def test_failed_speculative_capture_ends_its_streams_without_fallback(
        nets, failing):
    """The programs come in the order target prefill, draft prefill, draft
    decode, verify; the third or the fourth fails: both streams end with the
    error after their prefill's token, and no one-step target decode is
    ever made in the verify's place."""
    _, tnet = _carry(_jax_conf("lstm"), 5)
    _, td = _carry(_jax_conf("draft"), 6)
    faults.arm("compile", "raise", nth=3 if failing == "draft_decode" else 4)
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           draft_net=td, spec_k=K, auto_start=False)
    try:
        streams = [cb.submit([i + 1], max_new_tokens=8) for i in range(2)]
        cb.start()
        for s in streams:
            got = []
            with pytest.raises(faults.FaultInjected):
                for t in s.tokens(timeout=60.0):
                    got.append(t)
            assert len(got) == 1
        entries = {r["entry"] for r in tnet.infer_cache.programs_summary()}
        assert entries == {"prefill"}
        assert cb.stats()["streams"]["failed"] == 2
        faults.disarm()
        assert len(cb.generate([3], max_new_tokens=6)) == 6
    finally:
        cb.stop()


# -- the CLI ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, nets):
    """JAX checkpoints of the char-LSTM target and its two drafts."""
    from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint

    root = tmp_path_factory.mktemp("spec")
    out = {}
    for name in ("lstm", "draft", "clone"):
        jnet = nets[name][0]
        out[name] = str(root / name)
        jax_checkpoint.save(out[name], jnet.params, conf=jnet.conf)
    return out


def _last_json(capsys):
    import json

    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("draft", ["draft", "clone"])
@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_cli_generate_with_a_draft_prints_the_jax_clis_tokens(
        checkpoints, capsys, draft, temperature):
    from deeplearning4j_tpu.cli.driver import main as jax_main
    from deeplearning4j_tpu_torch.cli.driver import main as torch_main

    argv = ["generate", "--model", checkpoints["lstm"], "--prompt", "1,2,3",
            "--max-new-tokens", "9", "--temperature", temperature, "--seed",
            "4", "--max-seq", "16"]
    spec = ["--draft", checkpoints[draft], "--spec-k", "3"]
    assert jax_main(argv) == 0
    plain = _last_json(capsys)
    assert jax_main(argv + spec) == 0
    want = _last_json(capsys)
    assert torch_main(argv + spec + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert got["tokens"] == want["tokens"] == plain["tokens"]
    assert got["n_tokens"] == 9 and got["fresh_compiles"] == 0


def test_cli_serve_with_a_draft_streams_jax_tokens(nets, checkpoints,
                                                   tmp_path):
    """`serve --generate --gen-draft CKPT --gen-spec-k 3`: the target's and
    the draft's programs captured before the socket opens, POST
    /v1/generate streams JAX's tokens, the acceptance is in /v1/stats, no
    program is made under traffic, SIGTERM drains."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import urllib.request

    from test_torch_generate import _post_generate

    jnet, jd = nets["lstm"][0], nets["clone"][0]
    want, _ = _serve(JaxBatcher, jnet, 6, 0.8, jd, ([1, 2, 3],))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
         "--model", checkpoints["lstm"], "--device", "cpu", "--generate",
         "--gen-slots", "2", "--gen-max-seq", "16", "--gen-draft",
         checkpoints["clone"], "--gen-spec-k", "3"],
        stdout=subprocess.PIPE, text=True, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=repo))
    try:
        startup = json.loads(proc.stdout.readline())
        assert startup["generation"]["spec_k"] == 3
        status, lines = _post_generate(startup["url"], {
            "prompt": [1, 2, 3], "max_new_tokens": 6, "temperature": 0.8,
            "rng_seed": 0})
        assert status == 200
        assert [x["token"] for x in lines[:-1]] == want[0]
        with urllib.request.urlopen(startup["url"] + "/v1/stats") as resp:
            gen = json.loads(resp.read())["generation"]
        # the startup line counts the target's captures; the batcher's
        # books add the draft's
        assert gen["fresh_compiles"] == startup["fresh_compiles"] + 2
        assert gen["speculative"]["rounds"] >= 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert json.loads(out.strip().splitlines()[-1])["drained"]


# -- on the card ------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_captured_verify_equals_the_eager_program(model, paged):
    """The captured verify (dense or paged) against its program run eagerly
    on a copy of the same state, in f32: samples, keys and the state after
    it bitwise; a second replay (a hit) leaves the first's outputs alone.
    Then a warmed batcher with a cloned draft serves the one-step pass's
    tokens and captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the verify graph has no CPU mode")
    jconf = _jax_conf(model)
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    net = ml.MultiLayerNetwork(conf, device="cuda", seed=0).init()
    ic = net.infer_cache
    rng = np.random.RandomState(8)
    toks = rng.randint(0, VOCAB, (2, K)).astype(np.int32)
    pos = np.asarray([3, 6], np.int32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (1, 2)])
    temps = np.asarray([0.0, 0.9], np.float32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    if paged:
        state = ic.init_paged_decode_state(conf, 2, 9, 4, "cuda")
    else:
        state = ic.init_decode_state(conf, 2, 16, "cuda")
    for t in tree_leaves(state):
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(
            t.numel()), dtype=torch.float32).to(t))
    eager_state = _copy(state)
    extra = (table,) if paged else ()
    fn = ic.verify_paged if paged else ic.verify
    sampled, keys_after, _ = fn(conf, net.params, state, toks, pos, keys,
                                temps, *extra)
    program = infer_cache._verify_program(conf, paged)
    args = [torch.as_tensor(a, device="cuda") for a in (toks, pos)]
    args += [torch.as_tensor(keys.astype(np.int64), device="cuda"),
             torch.as_tensor(temps, device="cuda")]
    args += [torch.as_tensor(a, device="cuda") for a in extra]
    want_s, want_k, new = program((net.params, eager_state), *args)
    infer_cache._write_carries((net.params, eager_state),
                               (want_s, want_k, new))
    assert torch.equal(sampled, want_s) and torch.equal(keys_after, want_k)
    for a, b in zip(tree_leaves(state), tree_leaves(eager_state)):
        assert torch.equal(a, b)
    held = sampled.clone()
    fn(conf, net.params, state, toks, pos, keys, temps, *extra)
    assert torch.equal(sampled, held) and ic.stats.misses == 1
    if model != "lstm":
        return
    clone = ml.MultiLayerNetwork(conf, device="cuda", seed=0).init()
    clone.params = [{k: v.clone() for k, v in lay.items()}
                    for lay in net.params]
    options = dict(page_size=4) if paged else {}
    plain, _ = _serve(ContinuousBatcher, net, 10, 0.0, None, **options)
    net.warmup_generate(slots=2, max_seq=16, prompt_buckets=(8,),
                        draft_net=clone, spec_k=K, **options)
    warmed = ic.stats.misses + clone.infer_cache.stats.misses
    got, st = _serve(ContinuousBatcher, net, 10, 0.0, clone, **options)
    assert got == plain
    assert st["fresh_compiles"] == warmed
    assert st["speculative"]["accepted_per_step"] > 1.0


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_bf16_speculative_streams_equal_the_jax_batchers(nets, temperature):
    """bf16 compute (the chip smoke's serving dtype): the speculative
    streams are the JAX batcher's and the port's one-step pass's token for
    token on the CPU. On the card 4 of 8 diverge from the one-step pass
    within 2e-2 max|logp| (cuBLAS sums a verify's 16-row GEMMs in another
    order than a step's 4-row ones; ROADMAP.md, deliberate differences)."""
    (jnet, tnet), (jd, td) = nets["transformer"], nets["draft"]
    jconf = jnet.conf.with_compute_dtype("bfloat16")
    jbf = jax_ml.MultiLayerNetwork(jconf, seed=0)
    jbf.params = jnet.params
    tbf = ml.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu")
    tbf.params = tnet.params
    want, jst = _serve(JaxBatcher, jbf, 10, temperature, jd)
    got, st = _serve(ContinuousBatcher, tbf, 10, temperature, td)
    plain, _ = _serve(ContinuousBatcher, tbf, 10, temperature, None)
    assert got == want == plain
    assert st["speculative"] == jst["speculative"]

"""The port's K steps a dispatch (`decode_block`, the infer cache's
`decode_multi*`, the batcher's pipelined blocks) against the JAX package's.

At the JAX tests' sizes, with JAX's params carried across: the port's
`ContinuousBatcher` gives the JAX batcher's tokens for K in {1, 4, 8},
greedy and at 0.8, dense and paged, on both generative zoo models; a row
whose budget runs out mid-block emits `BLOCK_SENTINEL` and keeps its
carries and key, in the program as in JAX's; pending admissions pin K to 1
and an admission restarts the ramp; a `decode.step` fault inside a block
ends one stream; a failed capture ends the streams it was decoding and
nothing falls back to one step a dispatch; `warmup_generate` captures the
whole K ladder. On the CPU the programs run eagerly with the keys and books
of the CUDA path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import decode as jax_decode  # noqa: E402
from deeplearning4j_tpu.serving.batcher import ContinuousBatcher as JaxBatcher  # noqa: E402,E501
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import decode  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402
from deeplearning4j_tpu_torch.serving import ContinuousBatcher  # noqa: E402
from deeplearning4j_tpu_torch.serving.batcher import decode_k_ladder  # noqa: E402,E501
from test_torch_generate import (MODELS, _books, _jax_tokens,  # noqa: E402
                                 _pair)

PROMPTS = ([1, 2, 3], [4, 5])


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def pairs():
    return {m: _pair(m) for m in MODELS}


def _run(cls, net, prompts, n_new, temperature, n_slots=2, max_seq=16,
         **kw):
    """Every prompt through a batcher of `cls` (stream i seeded i), all
    queued before it starts: the tokens of each stream and its stats."""
    cb = cls(net, n_slots=n_slots, max_seq=max_seq, prompt_buckets=(8,),
             auto_start=False, **kw)
    try:
        streams = [cb.submit(list(p), max_new_tokens=n_new,
                             temperature=temperature, rng_seed=i)
                   for i, p in enumerate(prompts)]
        cb.start()
        return [list(s.tokens(timeout=60.0)) for s in streams], cb.stats()
    finally:
        cb.stop()


# -- token parity: any K, both samplers, dense and paged -------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("paged", [False, True])
def test_block_tokens_equal_the_jax_batchers(pairs, model, temperature, k,
                                             paged):
    jnet, tnet = pairs[model]
    kw = dict(page_size=4 if paged else 0, steps_per_dispatch=k)
    want, _ = _run(JaxBatcher, jnet, PROMPTS, 10, temperature, **kw)
    assert want == [_jax_tokens(jnet, p, 10, temperature, i)[0]
                    for i, p in enumerate(PROMPTS)]
    got, st = _run(ContinuousBatcher, tnet, PROMPTS, 10, temperature, **kw)
    assert got == want
    assert st["steps_per_dispatch"] == k
    assert st["streams"] == {"admitted": 2, "completed": 2, "failed": 0}
    if paged:
        assert st["kv_pages"]["live"] == 0


def test_block_reaches_kmax_and_reports_the_host_share(pairs):
    _, tnet = pairs["lstm"]
    got, st = _run(ContinuousBatcher, tnet, ([1, 2], [1, 2]), 28, 0.0,
                   max_seq=32, steps_per_dispatch=8)
    assert [len(t) for t in got] == [28, 28]
    h = st["decode_block_steps"]
    assert h["bounds"] == [1, 2, 4, 8, 16]
    assert h["counts"][3] > 0  # the ramp reached K = 8
    assert h["sum"] == 27  # the tokens after the prefill's, a step each
    assert 0.0 <= st["host_overhead_fraction"] <= 1.0
    assert st["decode_host_seconds_total"] > 0.0


def test_k_ladder_is_the_jax_packages():
    from deeplearning4j_tpu.optimize import tunables

    for k in (1, 2, 3, 4, 6, 8, 16):
        assert decode_k_ladder(k) == tunables.decode_k_ladder(k)


# -- a row frozen mid-block ---------------------------------------------------------

def _block_inputs(paged):
    tok = np.asarray([1, 4], np.int32)
    pos = np.zeros((2,), np.int32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (0, 1)])
    temps = np.asarray([0.0, 0.8], np.float32)
    table = (np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32) if paged
             else None)
    return tok, pos, keys, temps, table


def _port_block(tnet, paged, rem, k):
    ic = tnet.infer_cache
    state = (ic.init_paged_decode_state(tnet.conf, 2, 9, 4, "cpu") if paged
             else ic.init_decode_state(tnet.conf, 2, 16, "cpu"))
    tok, pos, keys, temps, table = _block_inputs(paged)
    rem = np.asarray(rem, np.int32)
    if paged:
        return ic.decode_multi_paged(tnet.conf, tnet.params, state, tok,
                                     pos, keys, temps, rem, table, k)
    return ic.decode_multi(tnet.conf, tnet.params, state, tok, pos, keys,
                           temps, rem, k)


def _jax_block(jnet, paged, rem, k):
    ic = jnet.infer_cache
    tok, pos, keys, temps, table = (None if a is None else jnp.asarray(a)
                                    for a in _block_inputs(paged))
    rem = jnp.asarray(rem, jnp.int32)
    if paged:
        state = ic.init_paged_decode_state(jnet.conf, 2, 9, 4)
        return ic.decode_multi_paged(jnet.conf, jnet.params, state, tok, pos,
                                     keys, temps, rem, table, k)
    state = ic.init_decode_state(jnet.conf, 2, 16)
    return ic.decode_multi(jnet.conf, jnet.params, state, tok, pos, keys,
                           temps, rem, k)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("paged", [False, True])
def test_frozen_row_emits_the_sentinel_and_keeps_its_carries(pairs, model,
                                                             paged):
    """Row 0 has 3 steps of budget in a K = 8 block, row 1 all 8: the
    tokens (sentinel included), last tokens and keys equal JAX's, the state
    is within 1e-5 of JAX's, and row 0's token, key, carries and K/V rows
    are bitwise those of a K = 3 block that ends where it froze."""
    jnet, tnet = pairs[model]
    toks, tok, keys, state = _port_block(tnet, paged, [3, 8], 8)
    jtoks, jtok, jkeys, jstate = _jax_block(jnet, paged, [3, 8], 8)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (8, 2)
    assert np.array_equal(toks.numpy(), np.asarray(jtoks))
    assert list(toks[3:, 0]) == [decode.BLOCK_SENTINEL] * 5
    assert (toks[:, 1] != decode.BLOCK_SENTINEL).all()
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert np.array_equal(keys.numpy().astype(np.uint32), np.asarray(jkeys))
    for t, j in zip(tree_leaves(state), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   rtol=1e-5, atol=1e-5)
    toks3, tok3, keys3, state3 = _port_block(tnet, paged, [3, 3], 3)
    assert torch.equal(toks3[:, 0], toks[:3, 0])
    assert int(tok3[0]) == int(tok[0]) and torch.equal(keys3[0], keys[0])
    for lay, lay3 in zip(state, state3):
        for name in ("h", "c"):
            if name in lay:
                assert torch.equal(lay[name][0], lay3[name][0])
        if "k" in lay and not paged:
            # the three positions row 0 consumed
            assert torch.equal(lay["k"][0, :3], lay3["k"][0, :3])
            assert torch.equal(lay["v"][0, :3], lay3["v"][0, :3])
    if paged and "k" in state[1]:
        for name in ("k", "v"):
            assert torch.equal(state[1][name][1, :3], state3[1][name][1, :3])


def test_decode_block_is_k_one_step_calls_in_the_layer_math(pairs):
    """`nn/decode.decode_block` against the K one-step loop it unrolls, and
    against JAX's `lax.scan` block: logp-driven greedy tokens equal."""
    jnet, tnet = pairs["transformer"]
    sample = lambda lp, k, t: nd_random.sample_tokens(lp.float(), k, t)  # noqa: E731
    tok, pos, keys, temps, _ = _block_inputs(False)
    args = [torch.as_tensor(a) for a in (tok, pos)]
    kt = nd_random.key_array(keys)
    tt = torch.as_tensor(temps)
    rem = torch.as_tensor([5, 5], dtype=torch.int32)
    with torch.inference_mode():
        state = decode.init_state(tnet.conf, 2, 16, "cpu")
        toks, *_ = decode.decode_block(tnet.conf, tnet.params, state, *args,
                                       kt, tt, rem, 5, sample)
        loop = decode.init_state(tnet.conf, 2, 16, "cpu")
        t, p, k, want = args[0], args[1], kt, []
        for _ in range(5):
            lp, loop = decode.decode_step(tnet.conf, tnet.params, loop, t, p)
            t, k = sample(lp, k, tt)
            want.append(t)
            p = p + 1
    assert torch.equal(toks, torch.stack(want))

    def jsample(lp, k, t):
        from deeplearning4j_tpu.optimize.infer_cache import _sample_tokens
        return _sample_tokens(lp, k, t)

    jtoks, *_ = jax_decode.decode_block(
        jnet.conf, jnet.params, jax_decode.init_state(jnet.conf, 2, 16),
        jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(keys),
        jnp.asarray(temps), jnp.asarray([5, 5], jnp.int32), 5, jsample)
    assert np.array_equal(toks.numpy(), np.asarray(jtoks))


def test_batcher_mid_block_freeze_parity(pairs):
    jnet, tnet = pairs["lstm"]
    refs = [_jax_tokens(jnet, [1, 2], 3, 0.0, 0)[0],
            _jax_tokens(jnet, [3, 4], 12, 0.0, 1)[0]]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           steps_per_dispatch=8)
    try:
        a = cb.submit([1, 2], max_new_tokens=3, rng_seed=0)
        b = cb.submit([3, 4], max_new_tokens=12, rng_seed=1)
        assert list(a.tokens(timeout=60.0)) == refs[0]
        assert list(b.tokens(timeout=60.0)) == refs[1]
    finally:
        cb.stop()


# -- the adaptive K ------------------------------------------------------------------

def test_pending_admissions_pin_k_to_one(pairs):
    _, tnet = pairs["lstm"]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           steps_per_dispatch=8, auto_start=False)
    try:
        assert cb._block_eligible()
        cb.submit([1, 2], max_new_tokens=4)
        assert not cb._block_eligible()
        cb._feed[0] = [3]  # a prompt feed in flight pins it too
        with cb._cv:
            cb._pending.clear()
        assert not cb._block_eligible()
    finally:
        cb.stop()
    assert not ContinuousBatcher(tnet, n_slots=2, max_seq=16,
                                 auto_start=False)._block_eligible()


def test_next_k_follows_the_ramp_and_the_budget(pairs):
    _, tnet = pairs["lstm"]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, auto_start=False,
                           steps_per_dispatch=6)
    assert cb._k_ladder == (1, 2, 4, 6)
    picks = []
    for ramp, budget in ((1, 9), (2, 9), (4, 9), (6, 9), (6, 5), (6, 1)):
        cb._ramp = ramp
        picks.append(cb._next_k(budget))
    assert picks == [1, 2, 4, 6, 4, 1]


def test_admissions_mid_run_restart_the_ramp(pairs):
    jnet, tnet = pairs["lstm"]
    refs = [_jax_tokens(jnet, [i + 1], 12, 0.0, i)[0] for i in range(4)]
    got, st = _run(ContinuousBatcher, tnet, [[i + 1] for i in range(4)], 12,
                   0.0, steps_per_dispatch=8)
    assert got == refs
    assert st["decode_block_steps"]["counts"][0] > 1  # K = 1 again


# -- faults inside a block ------------------------------------------------------------

def test_block_fault_fails_one_stream_others_decode_on(pairs):
    """`decode.step` fires per slot per scheduled position: with two slots,
    block 1 (K = 1) fires slot 0, slot 1; block 2 (K = 2) fires slot 0
    twice, so nth=4 lands inside a block. Slot 0's stream ends with the
    error before its rows go; slot 1's finishes with JAX's tokens."""
    jnet, tnet = pairs["lstm"]
    ref_b = _jax_tokens(jnet, [3, 4], 14, 0.0, 1)[0]
    faults.arm("decode.step", "raise", nth=4)
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=32, prompt_buckets=(8,),
                           steps_per_dispatch=8, auto_start=False)
    try:
        a = cb.submit([1, 2], max_new_tokens=20, rng_seed=0)
        b = cb.submit([3, 4], max_new_tokens=14, rng_seed=1)
        cb.start()
        assert list(b.tokens(timeout=60.0)) == ref_b
        with pytest.raises(faults.FaultInjected):
            list(a.tokens(timeout=60.0))
        st = cb.stats()
        assert st["streams"]["failed"] == 1
        assert st["streams"]["completed"] == 1
        faults.disarm()
        assert len(cb.generate([5], max_new_tokens=3)) == 3
    finally:
        cb.stop()


def test_failed_block_capture_ends_its_streams_without_fallback():
    """The third program made (prefill, decode-multi[1], then
    decode-multi[2]) fails: both streams end with the error after the
    tokens of the block before it, and no one-step program is ever made in
    its place."""
    _, tnet = _pair("lstm", seed=3)
    faults.arm("compile", "raise", nth=3)
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           steps_per_dispatch=4, auto_start=False)
    try:
        streams = [cb.submit([i + 1], max_new_tokens=10) for i in range(2)]
        cb.start()
        for s in streams:
            got = []
            with pytest.raises(faults.FaultInjected):
                for t in s.tokens(timeout=60.0):
                    got.append(t)
            assert len(got) == 2  # the prefill's and block 1's
        entries = {r["entry"] for r in tnet.infer_cache.programs_summary()}
        assert entries == {"prefill", "decode-multi[1]"}
        assert cb.stats()["streams"]["failed"] == 2
        faults.disarm()
        assert len(cb.generate([3], max_new_tokens=6)) == 6
    finally:
        cb.stop()


# -- warm-up covers the ladder ----------------------------------------------------------

@pytest.mark.parametrize("options", [
    {"steps_per_dispatch": 4},
    {"steps_per_dispatch": 4, "page_size": 4, "prefix_cache": True}],
    ids=["dense", "paged-prefix"])
def test_warmup_covers_the_k_ladder_and_books_as_jax(options):
    jnet, tnet = _pair("lstm", seed=4)
    want = jnet.warmup_generate(slots=2, max_seq=16, prompt_buckets=(8,),
                                **options)
    got = tnet.warmup_generate(slots=2, max_seq=16, prompt_buckets=(8,),
                               **options)
    for key in ("slots", "max_seq", "prompt_buckets", "page_size",
                "prefix_cache", "steps_per_dispatch"):
        assert got[key] == want[key]
    assert _books(tnet.infer_cache) == _books(jnet.infer_cache)
    assert sorted(r["entry"] for r in tnet.infer_cache.programs_summary()) \
        == sorted(r["entry"] for r in jnet.infer_cache.programs_summary())
    warmed = tnet.infer_cache.stats.misses
    toks, st = _run(ContinuousBatcher, tnet, ([1, 2], [2, 3]), 12, 0.0,
                    **options)
    assert [len(t) for t in toks] == [12, 12]
    assert tnet.infer_cache.stats.misses == warmed
    assert st["fresh_compiles"] == warmed
    assert st["decode_block_steps"]["count"] > 0


# -- on the card ------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_captured_block_equals_captured_steps(model, paged):
    """The captured K = 4 block (dense or paged) against four replays of the
    captured one-step decode on a dense table: tokens and keys bitwise, and
    the block's outputs are copies that the next replay leaves alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the decode graphs have no CPU mode")
    from deeplearning4j_tpu_torch.nn import multilayer as ml
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from test_torch_generate import _jax_conf

    net = ml.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(_jax_conf(model).to_json()),
        device="cuda", seed=0).init()
    ic = net.infer_cache
    tok, pos, keys, temps, table = _block_inputs(paged)
    dense = ic.init_decode_state(net.conf, 2, 16, "cuda")
    t, k, want = tok, keys, []
    p = pos.copy()
    for _ in range(4):
        t, k, dense = ic.decode(net.conf, net.params, dense, t, p, k, temps)
        want.append(t.clone())
        p = p + 1
    rem = np.full((2,), 4, np.int32)
    if paged:
        state = ic.init_paged_decode_state(net.conf, 2, 9, 4, "cuda")
        run = lambda: ic.decode_multi_paged(  # noqa: E731
            net.conf, net.params, state, tok, pos, keys, temps, rem, table, 4)
    else:
        state = ic.init_decode_state(net.conf, 2, 16, "cuda")
        run = lambda: ic.decode_multi(  # noqa: E731
            net.conf, net.params, state, tok, pos, keys, temps, rem, 4)
    toks, last, k4, _ = run()
    assert torch.equal(toks, torch.stack(want))
    assert torch.equal(last, t) and torch.equal(k4, k)
    held = toks.clone()
    run()  # a second replay (a hit) writes its own outputs
    assert torch.equal(toks, held)
    assert ic.stats.misses == 2

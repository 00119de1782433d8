"""The port's KV-cache generation vs the JAX package's.

At the JAX tests' sizes (`char_lstm(13, hidden=16, n_layers=2)`,
`char_transformer(13, d_model=16, n_blocks=2, n_heads=2, max_seq_len=32)`),
with JAX's params carried across (`checkpoint.params_from_numpy`) and
inputs from numpy seeds: `nn/decode.py` (logp and state within 1e-5 f32),
the infer cache's `prefill` and `decode` (token trajectories and keys
identical to JAX's `ic.prefill` + `ic.decode`, greedy and at temperature),
`CharLSTM.generate`, the `ContinuousBatcher`, POST /v1/generate and the
CLI's `generate`. On the CPU the cached programs run eagerly with the keys
and books of the CUDA path; the captured path runs on the card (`-m
cuda`).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.cli.driver import main as jax_main  # noqa: E402
from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.models.char_lstm import CharLSTM as JaxCharLSTM  # noqa: E402,E501
from deeplearning4j_tpu.nn import decode as jax_decode  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.cli.driver import main as torch_main  # noqa: E402,E501
from deeplearning4j_tpu_torch.models.char_lstm import CharLSTM  # noqa: E402
from deeplearning4j_tpu_torch.nd import kernels  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import decode  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.layers import get_layer  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402
from deeplearning4j_tpu_torch.serving import (ContinuousBatcher,  # noqa: E402
                                              ServerOverloaded)

VOCAB = 13
MODELS = ["lstm", "transformer"]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _jax_conf(model):
    if model == "lstm":
        return jax_zoo.char_lstm(VOCAB, hidden=16, n_layers=2)
    return jax_zoo.char_transformer(VOCAB, d_model=16, n_blocks=2,
                                    n_heads=2, max_seq_len=32)


def _pair(model, seed=0):
    jconf = _jax_conf(model)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=seed).init()
    tnet = ml.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu")
    tnet.params = checkpoint.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), "cpu")
    return jnet, tnet


@pytest.fixture(scope="module")
def pairs():
    return {m: _pair(m) for m in MODELS}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _state_close(tstate, jstate, tol=1e-5):
    jl = jax.tree_util.tree_leaves(jstate)
    tl = tree_leaves(tstate)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, tol)


def _jax_tokens(jnet, prompt, n_new, temperature=0.0, rng_seed=0,
                max_seq=16, bucket=8):
    """JAX's `ic.prefill` + `ic.decode` loop (the batcher's per-slot
    sequence): tokens and the last keys."""
    ic = jnet.infer_cache
    state = ic.init_decode_state(jnet.conf, 1, max_seq)
    pb = np.zeros((1, bucket), np.int32)
    pb[0, :len(prompt)] = prompt
    keys = jnp.asarray(np.asarray(jax.random.PRNGKey(rng_seed))[None])
    temps = jnp.full((1,), float(temperature), jnp.float32)
    tok, keys, state = ic.prefill(jnet.conf, jnet.params, state,
                                  jnp.asarray(pb),
                                  jnp.asarray([len(prompt)], jnp.int32),
                                  keys, temps)
    got = [int(tok[0])]
    pos = jnp.asarray([len(prompt)], jnp.int32)
    for _ in range(n_new - 1):
        tok, keys, state = ic.decode(jnet.conf, jnet.params, state, tok,
                                     pos, keys, temps)
        got.append(int(tok[0]))
        pos = pos + 1
    return got, np.asarray(keys)


def _port_tokens(tnet, prompt, n_new, temperature=0.0, rng_seed=0,
                 max_seq=16, bucket=8, state=None):
    ic = tnet.infer_cache
    if state is None:
        state = ic.init_decode_state(tnet.conf, 1, max_seq, "cpu")
    pb = np.zeros((1, bucket), np.int32)
    pb[0, :len(prompt)] = prompt
    keys = nd_random.prng_key(rng_seed)[None]
    temps = np.full((1,), float(temperature), np.float32)
    tok, keys, state = ic.prefill(tnet.conf, tnet.params, state, pb,
                                  np.asarray([len(prompt)], np.int32),
                                  keys, temps)
    got = [int(tok[0])]
    pos = np.asarray([len(prompt)], np.int32)
    for _ in range(n_new - 1):
        tok, keys, state = ic.decode(tnet.conf, tnet.params, state, tok,
                                     pos, keys, temps)
        got.append(int(tok[0]))
        pos = pos + 1
    return got, keys.numpy().astype(np.uint32)


def _books(cache):
    d = cache.stats.as_dict()
    return {k: d[k] for k in ("hits", "misses", "steps", "entries")}


# -- nn/decode.py --------------------------------------------------------------

def _generative_cases():
    tf = jax_zoo.char_transformer(8, d_model=8, n_blocks=1, n_heads=2,
                                  max_seq_len=8)
    return {
        "char_lstm": (jax_zoo.char_lstm(8, hidden=4, n_layers=1), True),
        "char_lstm_embed": (jax_zoo.char_lstm(8, hidden=4, n_layers=2,
                                              embed=6), True),
        "char_transformer": (tf, True),
        "mlp": (jax_zoo.mlp(n_in=4, hidden=[4], n_out=2), False),
        "not_causal": (tf.replace(confs=tuple(
            c.replace(causal=False) for c in tf.confs)), False),
        "extra_preprocessor": (tf.replace(input_preprocessors=(
            (1, "rnn_to_ff"),) + tuple(tf.input_preprocessors)), False),
    }


@pytest.mark.parametrize("name", sorted(_generative_cases()))
def test_check_generative_accepts_and_rejects_as_jax(name):
    jconf, ok = _generative_cases()[name]
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    if ok:
        want = jax_decode.check_generative(jconf)
        got = decode.check_generative(tconf)
        assert [str(t) for t in got] == [str(t) for t in want]
        assert (decode.positional_bound(tconf)
                == jax_decode.positional_bound(jconf))
    else:
        with pytest.raises(ValueError) as jerr:
            jax_decode.check_generative(jconf)
        with pytest.raises(ValueError) as terr:
            decode.check_generative(tconf)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("model", MODELS)
def test_init_state_matches_jax(pairs, model):
    jnet, tnet = pairs[model]
    want = jax_decode.init_state(jnet.conf, 3, 16)
    got = decode.init_state(tnet.conf, 3, 16, "cpu")
    _state_close(got, want, 0.0)
    for t, j in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    if model == "transformer":
        with pytest.raises(ValueError, match="positional table"):
            decode.init_state(tnet.conf, 1, 64, "cpu")
        with pytest.raises(ValueError, match="positional table"):
            jax_decode.init_state(jnet.conf, 1, 64)


def _prompts(seed, rows=3, bucket=8):
    rs = np.random.RandomState(seed)
    prompt = rs.randint(0, VOCAB, (rows, bucket)).astype(np.int32)
    length = rs.randint(1, bucket + 1, rows).astype(np.int32)
    return prompt, length


@pytest.mark.parametrize("model", MODELS)
def test_prefill_and_decode_step_match_jax(pairs, model):
    """prefill of ragged rows, then three decode steps: logp and every
    state tensor within 1e-5 (f32) of JAX's after each call."""
    jnet, tnet = pairs[model]
    prompt, length = _prompts(1)
    jstate = jax_decode.init_state(jnet.conf, 3, 16)
    tstate = decode.init_state(tnet.conf, 3, 16, "cpu")
    jl, jstate = jax_decode.prefill(jnet.conf, jnet.params, jstate,
                                    jnp.asarray(prompt), jnp.asarray(length))
    with torch.inference_mode():
        tl, tstate = decode.prefill(tnet.conf, tnet.params, tstate,
                                    torch.as_tensor(prompt),
                                    torch.as_tensor(length))
    _close(tl, jl)
    _state_close(tstate, jstate)
    pos = length.copy()
    rs = np.random.RandomState(2)
    for _ in range(3):
        tok = rs.randint(0, VOCAB, 3).astype(np.int32)
        jl, jstate = jax_decode.decode_step(jnet.conf, jnet.params, jstate,
                                            jnp.asarray(tok),
                                            jnp.asarray(pos))
        with torch.inference_mode():
            tl, tstate = decode.decode_step(tnet.conf, tnet.params, tstate,
                                            torch.as_tensor(tok),
                                            torch.as_tensor(pos))
        _close(tl, jl)
        _state_close(tstate, jstate)
        pos = pos + 1


def test_lstm_prefill_is_bitwise_repeated_step_and_freezes_past_length(pairs):
    _, tnet = pairs["lstm"]
    c, p = tnet.conf.conf(0), tnet.params[0]
    layer = get_layer(c.layer_type)
    rs = np.random.RandomState(3)
    x = torch.as_tensor(rs.randn(2, 6, c.n_in).astype(np.float32))
    length = torch.as_tensor([2, 6])
    zeros = torch.zeros((2, c.n_out))
    hs, h, cc = layer.prefill(p, c, x, zeros, zeros, length)
    # repeated step() calls at the same batch (a product's rounding may
    # depend on its row count)
    sh, sc, carries = zeros, zeros, []
    for t in range(6):
        sh, sc = layer.step(p, c, x[:, t], sh, sc)
        carries.append((sh, sc))
    for row, n in enumerate((2, 6)):
        assert torch.equal(h[row], carries[n - 1][0][row])
        assert torch.equal(cc[row], carries[n - 1][1][row])
        # a frozen row repeats its carry past its length
        assert torch.equal(hs[row, -1], carries[n - 1][0][row])


def test_attention_prefill_through_the_flash_wrapper_matches_full():
    """With attention_impl "flash" the prefill reaches
    `kernels.flash_attention` (on the CPU its plain version), the path the
    card takes; it matches the "full" impl within 1e-5 and writes the same
    K/V rows."""
    jconf = _jax_conf("transformer")
    out = {}
    for impl in ("flash", "full"):
        tconf = MultiLayerConfiguration.from_json(jconf.replace(
            confs=tuple(c.replace(attention_impl=impl)
                        for c in jconf.confs)).to_json())
        net = ml.MultiLayerNetwork(tconf, device="cpu", seed=0).init()
        torch.manual_seed(0)
        net.params = checkpoint.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jax_ml.MultiLayerNetwork(
                jconf, seed=0).init().params), "cpu")
        prompt, length = _prompts(4)
        state = decode.init_state(tconf, 3, 16, "cpu")
        with torch.inference_mode():
            out[impl] = decode.prefill(tconf, net.params, state,
                                       torch.as_tensor(prompt),
                                       torch.as_tensor(length))
    _close(out["flash"][0], out["full"][0].numpy())
    for a, b in zip(tree_leaves(out["flash"][1]), tree_leaves(out["full"][1])):
        _close(a, b.numpy())


# -- the infer cache's generation programs ------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("temperature,rng_seed", [(0.0, 0), (0.7, 3),
                                                  (0.9, 7), (1.3, 11)])
def test_cached_trajectory_is_token_identical_to_jax(pairs, model,
                                                     temperature, rng_seed):
    jnet, tnet = pairs[model]
    prompt = [2, 5, 1] if rng_seed % 2 else [1, 2, 3]
    want, want_keys = _jax_tokens(jnet, prompt, 10, temperature, rng_seed)
    got, got_keys = _port_tokens(tnet, prompt, 10, temperature, rng_seed)
    assert got == want
    assert np.array_equal(got_keys, want_keys)


@pytest.mark.parametrize("model", MODELS)
def test_generation_programs_key_and_count_as_jax(model):
    jnet, tnet = _pair(model, seed=1)
    for prompt, bucket in (([1], 8), ([2, 3], 8), ([4], 4)):
        _jax_tokens(jnet, prompt, 4, bucket=bucket)
        _port_tokens(tnet, prompt, 4, bucket=bucket)
        assert _books(tnet.infer_cache) == _books(jnet.infer_cache)
    got = tnet.infer_cache.programs_summary()
    want = jnet.infer_cache.programs_summary()
    assert [(r["entry"], r["bucket"]) for r in got] == \
        [(r["entry"], r["bucket"]) for r in want]


def test_decode_writes_the_state_it_was_given_in_place(pairs):
    _, tnet = pairs["transformer"]
    ic = tnet.infer_cache
    state = ic.init_decode_state(tnet.conf, 2, 16, "cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(state)]
    tok, keys, out = ic.decode(tnet.conf, tnet.params, state,
                               np.asarray([1, 2], np.int32),
                               np.asarray([0, 3], np.int32),
                               np.zeros((2, 2), np.uint32),
                               np.zeros((2,), np.float32))
    assert out is state
    assert [t.data_ptr() for t in tree_leaves(out)] == ptrs
    k = state[1]["k"]
    assert k[0, 0].abs().sum() > 0 and k[1, 3].abs().sum() > 0
    assert k[0, 1:].abs().sum() == 0 and k[1, :3].abs().sum() == 0
    assert tok.dtype == torch.int32 and tuple(keys.shape) == (2, 2)


def test_decode_refuses_out_of_vocabulary_ids_on_the_host(pairs):
    _, tnet = pairs["transformer"]
    ic = tnet.infer_cache
    state = ic.init_decode_state(tnet.conf, 1, 16, "cpu")
    with pytest.raises(ValueError, match="token ids"):
        ic.decode(tnet.conf, tnet.params, state,
                  np.asarray([VOCAB], np.int32), np.zeros(1, np.int32),
                  np.zeros((1, 2), np.uint32), np.zeros(1, np.float32))


# -- CharLSTM -------------------------------------------------------------------

TEXT = "the quick brown fox jumps over the lazy dog " * 4


@pytest.fixture(scope="module")
def char_models():
    jm = JaxCharLSTM(hidden=16, n_layers=1, seq_len=8, iterations=2).fit(TEXT)
    tm = CharLSTM(hidden=16, n_layers=1, seq_len=8, device="cpu")
    tm.chars, tm.char_index = list(jm.chars), dict(jm.char_index)
    tm.net = ml.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jm.net.conf.to_json()),
        device="cpu")
    tm.net.params = checkpoint.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.net.params), "cpu")
    return jm, tm


@pytest.mark.parametrize("seed_text,temperature,rng_seed",
                         [("the q", 0.0, 0), ("dog", 0.9, 7),
                          ("fox ", 0.8, 3)])
def test_charlstm_generate_equals_sample_and_jax(char_models, seed_text,
                                                 temperature, rng_seed):
    jm, tm = char_models
    got = tm.generate(seed_text, n=12, temperature=temperature,
                      rng_seed=rng_seed)
    assert got == tm.sample(seed_text, n=12, temperature=temperature,
                            rng_seed=rng_seed)
    assert got == jm.generate(seed_text, n=12, temperature=temperature,
                              rng_seed=rng_seed)
    assert got == jm.sample(seed_text, n=12, temperature=temperature,
                            rng_seed=rng_seed)


def test_charlstm_generate_replays_its_programs(char_models):
    _, tm = char_models
    ic = tm.net.infer_cache
    tm.generate("the", n=5)
    misses = ic.stats.misses
    again = tm.generate("the", n=5)
    assert ic.stats.misses == misses
    assert again == tm.generate("the", n=5)


# -- ContinuousBatcher ------------------------------------------------------------

def _drain(stream, timeout=30.0):
    return list(stream.tokens(timeout=timeout))


@pytest.mark.parametrize("model", MODELS)
def test_batcher_generates_jax_tokens_and_reports(pairs, model):
    jnet, tnet = pairs[model]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,))
    try:
        want, _ = _jax_tokens(jnet, [1, 2, 3], 6)
        assert cb.generate([1, 2, 3], max_new_tokens=6) == want
        want_t, _ = _jax_tokens(jnet, [4, 2], 5, temperature=0.8,
                                rng_seed=5)
        s1 = cb.submit([4, 2], max_new_tokens=5, temperature=0.8,
                       rng_seed=5)
        s2 = cb.submit([3, 4], max_new_tokens=4)
        assert _drain(s1) == want_t
        assert len(_drain(s2)) == 4
        assert s1.ttft_s is not None and s1.ttft_s >= 0.0
        st = cb.stats()
        assert st["streams"] == {"admitted": 3, "completed": 3, "failed": 0}
        assert st["tokens"] == 15
        assert st["slots"] == {"width": 2, "active": 0, "free": 2}
        h = st["ttft_hist_s"]
        assert sum(h["counts"]) + h["inf"] == h["count"] == 3
        assert {"tokens_per_sec", "ttft_ms", "queue_depth", "max_seq",
                "prompt_buckets", "continuous", "steps_per_dispatch",
                "host_overhead_fraction", "decode_host_seconds_total",
                "decode_block_steps", "fresh_compiles"} <= set(st)
    finally:
        cb.stop()


def test_batcher_interleaves_admissions_without_barrier(pairs):
    _, tnet = pairs["lstm"]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=32, prompt_buckets=(8,))
    try:
        long = cb.submit([1], max_new_tokens=24)
        shorts = [cb.submit([2, 3], max_new_tokens=2) for _ in range(3)]
        for s in shorts:
            assert len(_drain(s)) == 2
            # the long stream was still decoding when each short one ended
            assert long.t_done is None or s.t_done <= long.t_done
        assert len(_drain(long)) == 24
        assert cb.stats()["streams"]["completed"] == 4
    finally:
        cb.stop()


def test_two_running_batchers_on_one_net_keep_their_own_tables(pairs):
    """The second batcher to start finds the cache's table taken and decodes
    in a private one: both give JAX's tokens."""
    jnet, tnet = pairs["transformer"]
    want, _ = _jax_tokens(jnet, [1, 2, 3], 6)
    first = ContinuousBatcher(tnet, n_slots=2, max_seq=16).start()
    second = ContinuousBatcher(tnet, n_slots=2, max_seq=16).start()
    try:
        assert first._state is not second._state
        streams = [b.submit([1, 2, 3], max_new_tokens=6)
                   for b in (first, second, first, second)]
        assert [_drain(s) for s in streams] == [want] * 4
    finally:
        first.stop()
        second.stop()
    again = ContinuousBatcher(tnet, n_slots=2, max_seq=16)
    try:
        assert again.generate([1, 2, 3], max_new_tokens=6) == want
    finally:
        again.stop()


def test_sequential_mode_still_serves_everything(pairs):
    _, tnet = pairs["lstm"]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           continuous=False)
    try:
        streams = [cb.submit([1, 2], max_new_tokens=3) for _ in range(5)]
        for s in streams:
            assert len(_drain(s)) == 3
        assert cb.stats()["streams"]["completed"] == 5
    finally:
        cb.stop()


def test_submit_validation_and_overload(pairs):
    _, tnet = pairs["transformer"]
    cb = ContinuousBatcher(tnet, n_slots=1, max_seq=8, prompt_buckets=(4,),
                           max_pending=1, auto_start=False)
    with pytest.raises(ValueError):
        cb.submit([], max_new_tokens=1)
    with pytest.raises(ValueError):
        cb.submit(list(range(8)), max_new_tokens=1)  # prompt fills the table
    with pytest.raises(ValueError):
        cb.submit([1], max_new_tokens=0)
    with pytest.raises(ValueError, match="token ids"):
        cb.submit([VOCAB], max_new_tokens=1)
    cb.submit([1], max_new_tokens=2)
    with pytest.raises(ServerOverloaded):
        cb.submit([1], max_new_tokens=2)  # the pending bound
    cb.stop()


def test_max_new_tokens_clamped_to_the_table(pairs):
    _, tnet = pairs["lstm"]
    cb = ContinuousBatcher(tnet, n_slots=1, max_seq=8, prompt_buckets=(4,))
    try:
        assert len(cb.generate([1, 2, 3], max_new_tokens=100)) == 8 - 3
    finally:
        cb.stop()


def test_positional_bound_checked_at_construction(pairs):
    _, tnet = pairs["transformer"]
    with pytest.raises(ValueError, match="positional"):
        ContinuousBatcher(tnet, n_slots=1, max_seq=64, auto_start=False)
    ContinuousBatcher(pairs["lstm"][1], n_slots=1, max_seq=512,
                      auto_start=False)


def test_decode_fault_fails_one_stream_others_decode_on(pairs):
    _, tnet = pairs["lstm"]
    # armed before the first submission: the first decode-table traversal
    # is slot 0, where the first stream is admitted
    faults.arm("decode.step", "raise", nth=1)
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=32, prompt_buckets=(8,))
    try:
        a = cb.submit([1, 2], max_new_tokens=20)
        b = cb.submit([3, 4], max_new_tokens=20)
        assert len(_drain(b)) == 20
        with pytest.raises(faults.FaultInjected):
            _drain(a)
        st = cb.stats()
        assert st["streams"]["failed"] == 1
        assert st["streams"]["completed"] == 1
        faults.disarm()
        assert len(cb.generate([5], max_new_tokens=3)) == 3
    finally:
        cb.stop()


def test_admit_fault_fails_only_the_admitted_stream(pairs):
    _, tnet = pairs["lstm"]
    faults.arm("generate.admit", "raise", nth=1)
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,))
    try:
        doomed = cb.submit([1], max_new_tokens=4)
        with pytest.raises(faults.FaultInjected):
            _drain(doomed)
        assert len(cb.generate([2], max_new_tokens=4)) == 4
        assert cb.stats()["streams"]["failed"] == 1
    finally:
        cb.stop()


@pytest.mark.parametrize("kwargs", [{"draft_net": "transformer",
                                     "spec_k": 3},
                                    {"spec_k": 3}])
def test_unported_generation_options_name_their_roadmap_item(pairs, kwargs):
    """Speculative decoding is ported (these options refused before,
    naming ROADMAP.md queue A item 8): a draft with attention raises the
    JAX package's ValueError at construction and at warm-up, and `spec_k`
    without a draft is 0, as in the JAX package, so the batcher decodes one
    step at a time and gives JAX's tokens."""
    from deeplearning4j_tpu.serving.batcher import ContinuousBatcher as JCB

    jnet, tnet = pairs["lstm"]
    if "draft_net" in kwargs:
        jdraft, tdraft = pairs[kwargs["draft_net"]]
        with pytest.raises(ValueError) as want:
            JCB(jnet, n_slots=1, max_seq=16, auto_start=False,
                draft_net=jdraft, spec_k=3)
        for make in (lambda: ContinuousBatcher(
                tnet, n_slots=1, max_seq=16, auto_start=False,
                draft_net=tdraft, spec_k=3),
                lambda: tnet.warmup_generate(
                    slots=1, max_seq=16, prompt_buckets=(8,),
                    draft_net=tdraft, spec_k=3)):
            with pytest.raises(ValueError) as got:
                make()
            assert str(got.value) == str(want.value)
        assert "recurrent-only" in str(want.value)
        return
    jcb = JCB(jnet, n_slots=1, max_seq=16, auto_start=False, **kwargs)
    cb = ContinuousBatcher(tnet, n_slots=1, max_seq=16, **kwargs)
    try:
        assert cb.spec_k == jcb.spec_k == 0
        assert cb.generate([1, 2, 3], max_new_tokens=5, temperature=0.8,
                           rng_seed=2) == _jax_tokens(jnet, [1, 2, 3], 5,
                                                      0.8, 2)[0]
        assert "speculative" not in cb.stats()
    finally:
        cb.stop()
    assert tnet.warmup_generate(slots=1, max_seq=16, prompt_buckets=(8,),
                                **kwargs)["spec_k"] == 0


@pytest.mark.parametrize("kwargs", [{"page_size": 4}, {"page_size": 4,
                                                       "n_pages": 5},
                                    {"prefix_cache": True},
                                    {"steps_per_dispatch": 4}],
                         ids=["page_size", "n_pages", "prefix_cache",
                              "steps_per_dispatch"])
def test_generation_options_serve_jax_tokens_after_warmup(kwargs):
    """The options that refused before this slice: warmed, then serving two
    streams, JAX's tokens with no new program."""
    jnet, tnet = _pair("transformer", seed=5)
    want = [_jax_tokens(jnet, [1, 2, 3], 6, 0.8, 2)[0],
            _jax_tokens(jnet, [4], 8, 0.0, 3)[0]]
    tnet.warmup_generate(slots=2, max_seq=16, prompt_buckets=(8,), **kwargs)
    misses = tnet.infer_cache.stats.misses
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           **kwargs)
    try:
        a = cb.submit([1, 2, 3], max_new_tokens=6, temperature=0.8,
                      rng_seed=2)
        b = cb.submit([4], max_new_tokens=8, rng_seed=3)
        assert [_drain(a), _drain(b)] == want
    finally:
        cb.stop()
    assert tnet.infer_cache.stats.misses == misses


def test_warmup_generate_then_batcher_makes_no_new_programs():
    _, tnet = _pair("transformer", seed=2)
    summary = tnet.warmup_generate(slots=2, max_seq=16,
                                   prompt_buckets=(4, 8))
    assert summary["slots"] == 2 and summary["prompt_buckets"] == [4, 8]
    misses = tnet.infer_cache.stats.misses
    assert misses == 3  # one decode table, two prefill buckets
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16,
                           prompt_buckets=(4, 8))
    try:
        _drain(cb.submit([1, 2], max_new_tokens=3))
        _drain(cb.submit([1, 2, 3, 4, 5], max_new_tokens=3))
    finally:
        cb.stop()
    assert tnet.infer_cache.stats.misses == misses
    assert cb.stats()["fresh_compiles"] == misses


# -- the paged KV pool ---------------------------------------------------------------

def _jax_batcher(jnet, prompts, n_new, temps, **kw):
    """The JAX package's ContinuousBatcher over the same streams (stream i
    seeded i), all queued before it starts: each stream's tokens."""
    from deeplearning4j_tpu.serving.batcher import ContinuousBatcher as JCB

    cb = JCB(jnet, prompt_buckets=(8,), auto_start=False, **kw)
    try:
        streams = [cb.submit(list(p), max_new_tokens=n_new, temperature=t,
                             rng_seed=i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        cb.start()
        return [_drain(x, 60.0) for x in streams], cb.stats()
    finally:
        cb.stop()


def _port_batcher(tnet, prompts, n_new, temps, **kw):
    cb = ContinuousBatcher(tnet, prompt_buckets=(8,), auto_start=False, **kw)
    try:
        streams = [cb.submit(list(p), max_new_tokens=n_new, temperature=t,
                             rng_seed=i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        cb.start()
        return [_drain(x, 60.0) for x in streams], cb.stats()
    finally:
        cb.stop()


@pytest.mark.parametrize("model", MODELS)
def test_paged_step_and_state_match_jax(pairs, model):
    jnet, tnet = pairs[model]
    want = jax_decode.init_paged_state(jnet.conf, 3, 13, 4)
    got = decode.init_paged_state(tnet.conf, 3, 13, 4, "cpu")
    _state_close(got, want, 0.0)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], np.int32)
    pos = np.asarray([0, 2, 5], np.int32)
    rs = np.random.RandomState(8)
    for _ in range(4):
        tok = rs.randint(0, VOCAB, 3).astype(np.int32)
        jl, want = jax_decode.decode_step_paged(
            jnet.conf, jnet.params, want, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(table))
        with torch.inference_mode():
            tl, got = decode.decode_step_paged(
                tnet.conf, tnet.params, got, torch.as_tensor(tok),
                torch.as_tensor(pos), torch.as_tensor(table))
        _close(tl, jl)
        _state_close(got, want)
        pos = pos + 1


def test_paged_step_is_the_dense_step_bit_for_bit(pairs):
    """Where max_seq is a whole number of pages, the paged step gathers the
    dense cache's shape and runs the dense step's score code: logp equal
    bit for bit on the CPU (the card holds the same in `chip_smoke.py`)."""
    _, tnet = pairs["transformer"]
    dense = decode.init_state(tnet.conf, 2, 16, "cpu")
    paged = decode.init_paged_state(tnet.conf, 2, 9, 4, "cpu")
    table = torch.as_tensor([[3, 1, 8, 5], [2, 7, 4, 6]])
    rs = np.random.RandomState(9)
    with torch.inference_mode():
        for p in range(6):
            tok = torch.as_tensor(rs.randint(0, VOCAB, 2))
            pos = torch.full((2,), p)
            ld, dense = decode.decode_step(tnet.conf, tnet.params, dense,
                                           tok, pos)
            lp, paged = decode.decode_step_paged(tnet.conf, tnet.params,
                                                 paged, tok, pos, table)
            assert torch.equal(ld, lp)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("k", [1, 4])
def test_paged_batcher_gives_the_jax_batchers_tokens(pairs, model, k):
    jnet, tnet = pairs[model]
    prompts, temps = ([1, 2, 3], [4, 5]), (0.0, 0.8)
    kw = dict(n_slots=2, max_seq=16, page_size=4, steps_per_dispatch=k)
    want, _ = _jax_batcher(jnet, prompts, 6, temps, **kw)
    got, st = _port_batcher(tnet, prompts, 6, temps, **kw)
    assert got == want
    pages = st["kv_pages"]
    assert pages["page_size"] == 4 and pages["total"] == 8
    assert pages["live"] == 0 and pages["free"] == pages["total"]


def test_paged_pool_frees_and_reuses_pages(pairs):
    _, tnet = pairs["lstm"]
    cb = ContinuousBatcher(tnet, n_slots=1, max_seq=16, prompt_buckets=(8,),
                           page_size=4)
    try:
        for _ in range(3):
            assert len(cb.generate([1, 2, 3], max_new_tokens=4)) == 4
            pages = cb.stats()["kv_pages"]
            assert pages["live"] == 0 and pages["free"] == pages["total"]
    finally:
        cb.stop()


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("k", [1, 8])
def test_overcommitted_pool_preempts_and_replays_token_identically(
        pairs, model, k):
    """4 slots of 4 pages share 6: admissions wait in the queue, streams
    that cannot grow are preempted, recomputed and their delivered tokens
    swallowed, so every stream arrives once and whole with the JAX batcher's
    tokens."""
    jnet, tnet = pairs[model]
    prompts = [[i + 1] for i in range(6)]
    temps = [0.8 if i % 2 else 0.0 for i in range(6)]
    kw = dict(n_slots=4, max_seq=16, page_size=4, n_pages=6,
              steps_per_dispatch=k)
    want, jst = _jax_batcher(jnet, prompts, 12, temps, **kw)
    got, st = _port_batcher(tnet, prompts, 12, temps, **kw)
    assert got == want
    assert got == [_jax_tokens(jnet, p, 12, t, i)[0]
                   for i, (p, t) in enumerate(zip(prompts, temps))]
    assert st["streams"] == {"admitted": 6, "completed": 6, "failed": 0}
    assert st["kv_pages"]["preempted_streams"] >= 1
    assert st["kv_pages"]["total"] == 6 and st["kv_pages"]["live"] == 0
    assert st["tokens"] == 6 * 12  # replayed tokens are not counted twice
    assert jst["kv_pages"]["preempted_streams"] >= 1


def test_page_pool_too_small_for_one_stream_rejected_at_construction(pairs):
    _, tnet = pairs["lstm"]
    with pytest.raises(ValueError, match="cannot hold even one"):
        ContinuousBatcher(tnet, n_slots=1, max_seq=16, prompt_buckets=(8,),
                          page_size=4, n_pages=3, auto_start=False)


def test_page_alloc_fault_fails_one_stream_neighbour_decodes_on(pairs):
    _, tnet = pairs["lstm"]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(4,),
                           page_size=4, auto_start=False)
    try:
        # the admissions allocate once each (traversals 1-2); the doomed
        # stream crosses into its second page first (prompt of 3 tokens,
        # then 2 steps: position 4 at traversal 3)
        faults.arm("decode.page_alloc", "raise", nth=3)
        doomed = cb.submit([1, 2, 3], max_new_tokens=10)
        ok = cb.submit([4], max_new_tokens=2)
        cb.start()
        assert len(_drain(ok)) == 2
        with pytest.raises(faults.FaultInjected):
            _drain(doomed)
        faults.disarm()
        st = cb.stats()
        assert st["streams"]["failed"] == 1
        assert st["kv_pages"]["live"] == 0
        assert len(cb.generate([5], max_new_tokens=3)) == 3
    finally:
        cb.stop()


# -- the prefix cache ------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_prefill_logp_matches_jax(pairs, model):
    """`prefill_logp` (no sampling) against JAX's within 1e-6 (f32), the
    state alike, and its row's first token drawn on the host is the
    device-sampling prefill's."""
    jnet, tnet = pairs[model]
    prompt, length = _prompts(5, rows=1)
    jlogp, jstate = jnet.infer_cache.prefill_logp(
        jnet.conf, jnet.params, jnet.infer_cache.init_decode_state(
            jnet.conf, 1, 16), jnp.asarray(prompt), jnp.asarray(length))
    ic = tnet.infer_cache
    logp, state = ic.prefill_logp(tnet.conf, tnet.params,
                                  ic.init_decode_state(tnet.conf, 1, 16,
                                                       "cpu"),
                                  prompt, length)
    assert logp.dtype == torch.float32 and tuple(logp.shape) == (1, VOCAB)
    _close(logp, jlogp, 1e-6)
    _state_close(state, jstate)
    from deeplearning4j_tpu_torch.serving.batcher import _host_sample

    for temp, seed in ((0.0, 0), (0.8, 3), (1.3, 7)):
        key = np.asarray(jax.random.PRNGKey(seed))
        tok, new_key = _host_sample(logp[0].numpy(), key, temp)
        t1, k1, _ = ic.prefill(tnet.conf, tnet.params,
                               ic.init_decode_state(tnet.conf, 1, 16, "cpu"),
                               prompt, length, key[None],
                               np.asarray([temp], np.float32))
        assert tok == int(t1[0])
        assert np.array_equal(new_key, k1[0].numpy().astype(np.uint32))


@pytest.mark.parametrize("model", MODELS)
def test_prefix_cache_exact_hit_token_identical_and_counted(pairs, model):
    jnet, tnet = pairs[model]
    ref_greedy = _jax_tokens(jnet, [1, 2, 3], 6)[0]
    ref_temp = _jax_tokens(jnet, [1, 2, 3], 6, 0.7, 9)[0]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           prefix_cache=True)
    try:
        assert cb.generate([1, 2, 3], max_new_tokens=6) == ref_greedy
        assert cb.generate([1, 2, 3], max_new_tokens=6) == ref_greedy
        s = cb.submit([1, 2, 3], max_new_tokens=6, temperature=0.7,
                      rng_seed=9)
        assert _drain(s) == ref_temp
        pc = cb.stats()["prefix_cache"]
        assert pc == {"hits": 2, "misses": 1, "entries": 1,
                      "match": "exact"}
        entry = next(iter(cb._prefix_lru.values()))
        # a host copy, not the shared admission row
        row_ptrs = {t.data_ptr() for t in tree_leaves(cb._row)}
        assert not {t.data_ptr() for t in tree_leaves(entry[2])} & row_ptrs
    finally:
        cb.stop()


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("paged", [False, True])
def test_prefix_cache_longest_match_parity(pairs, model, paged):
    jnet, tnet = pairs[model]
    ref = _jax_tokens(jnet, [1, 2, 3, 4, 5, 6], 5, 0.8, 1)[0]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           prefix_cache=True, prefix_match="longest",
                           page_size=4 if paged else 0,
                           steps_per_dispatch=4)
    try:
        cb.generate([1, 2, 3, 4], max_new_tokens=3)  # stores the prefix
        s = cb.submit([1, 2, 3, 4, 5, 6], max_new_tokens=5, temperature=0.8,
                      rng_seed=1)
        assert _drain(s) == ref
        pc = cb.stats()["prefix_cache"]
        assert pc["hits"] == 1 and pc["misses"] == 1
        assert pc["match"] == "longest"
    finally:
        cb.stop()


def test_prefix_lookup_fault_falls_back_to_cold_prefill(pairs):
    jnet, tnet = pairs["lstm"]
    ref = _jax_tokens(jnet, [1, 2, 3], 6)[0]
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           prefix_cache=True)
    try:
        assert cb.generate([1, 2, 3], max_new_tokens=6) == ref
        faults.arm("generate.prefix_lookup", "raise", nth=1)
        a = cb.submit([1, 2, 3], max_new_tokens=6)
        b = cb.submit([1, 2, 3], max_new_tokens=6)
        assert _drain(a) == ref and _drain(b) == ref
        st = cb.stats()
        assert st["streams"]["failed"] == 0
        assert st["prefix_cache"]["misses"] == 2
        assert st["prefix_cache"]["hits"] == 1
    finally:
        cb.stop()


def test_all_options_together_give_jax_tokens(pairs):
    """Paged pool, prefix cache (longest) and K = 8 at once, with a hit and
    an overcommitted pool: the JAX batcher's tokens for the same options."""
    jnet, tnet = pairs["transformer"]
    prompts = [[1, 2, 3], [1, 2, 3], [1, 2, 3, 4, 5], [6]]
    temps = [0.0, 0.8, 0.0, 0.8]
    kw = dict(n_slots=2, max_seq=16, page_size=4, n_pages=5,
              prefix_cache=True, prefix_match="longest",
              steps_per_dispatch=8)
    want, _ = _jax_batcher(jnet, prompts, 9, temps, **kw)
    got, st = _port_batcher(tnet, prompts, 9, temps, **kw)
    assert got == want
    assert st["prefix_cache"]["hits"] >= 1
    assert st["kv_pages"]["live"] == 0
    assert st["streams"]["completed"] == 4


def test_options_off_make_only_the_default_programs(pairs):
    _, tnet = _pair("lstm", seed=6)
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,))
    try:
        assert len(cb.generate([1, 2], max_new_tokens=4)) == 4
        kinds = {r["entry"] for r in tnet.infer_cache.programs_summary()}
        assert kinds == {"decode", "prefill"}
        st = cb.stats()
        assert "kv_pages" not in st and "prefix_cache" not in st
        assert st["steps_per_dispatch"] == 1
    finally:
        cb.stop()


def test_warmup_generate_covers_every_option_combination():
    _, tnet = _pair("lstm", seed=7)
    options = dict(page_size=4, prefix_cache=True, steps_per_dispatch=4)
    summary = tnet.warmup_generate(slots=2, max_seq=16, prompt_buckets=(8,),
                                   **options)
    assert (summary["page_size"], summary["prefix_cache"],
            summary["steps_per_dispatch"]) == (4, True, 4)
    before = tnet.infer_cache.stats.misses
    kinds = {r["entry"] for r in tnet.infer_cache.programs_summary()}
    assert kinds == {"decode-paged", "prefill-logp", "decode-multi-paged[1]",
                     "decode-multi-paged[2]", "decode-multi-paged[4]"}
    cb = ContinuousBatcher(tnet, n_slots=2, max_seq=16, prompt_buckets=(8,),
                           prefix_match="longest", **options)
    try:
        assert len(cb.generate([1, 2, 3], max_new_tokens=6)) == 6
        assert len(cb.generate([1, 2, 3, 4], max_new_tokens=6)) == 6
        assert tnet.infer_cache.stats.misses == before
        assert cb.stats()["fresh_compiles"] == before
    finally:
        cb.stop()


# -- HTTP: /v1/generate -------------------------------------------------------------

def _post_generate(url, body, timeout=30):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        lines = [json.loads(x) for x in resp.read().decode().splitlines()
                 if x.strip()]
        return resp.status, lines


def _post_error(url, body):
    try:
        _post_generate(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


def test_http_generate_streams_jax_tokens(pairs):
    jnet, tnet = pairs["transformer"]
    server = tnet.serve(port=0, generate=True, gen_slots=2, gen_max_seq=16,
                        gen_prompt_buckets=(8,))
    try:
        want, _ = _jax_tokens(jnet, [1, 2, 3], 5, temperature=0.8,
                              rng_seed=3)
        results = {}

        def client(i):
            results[i] = _post_generate(server.url, {
                "prompt": [1, 2, 3], "max_new_tokens": 5,
                "temperature": 0.8, "rng_seed": 3})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for status, lines in results.values():
            assert status == 200
            assert [x["token"] for x in lines[:-1]] == want
            assert lines[-1]["done"] is True and lines[-1]["tokens"] == 5
        with urllib.request.urlopen(server.url + "/v1/stats") as resp:
            st = json.loads(resp.read())
        assert st["generation"]["streams"]["completed"] == 3
        assert any(p["entry"] == "decode" for p in st["programs"])
    finally:
        server.drain()


def test_http_generate_error_envelopes(pairs):
    _, tnet = pairs["transformer"]
    server = tnet.serve(port=0, generate=True, gen_slots=1, gen_max_seq=16,
                        gen_prompt_buckets=(8,))
    try:
        for body in ({}, {"prompt": "x"}, {"prompt": []},
                     {"prompt": list(range(16))}, {"prompt": [VOCAB]},
                     {"prompt": [1], "max_new_tokens": 0}):
            code, err = _post_error(server.url, body)
            assert code == 400 and "bad request" in err["error"], body
        faults.arm("generate.admit", "raise", nth=1)
        code, err = _post_error(server.url, {"prompt": [1, 2]})
        assert code == 500 and "generation failed" in err["error"]
        status, lines = _post_generate(server.url, {"prompt": [1, 2],
                                                    "max_new_tokens": 3})
        assert status == 200 and len(lines) == 4
    finally:
        server.drain()
    plain = tnet.serve(port=0)
    try:
        code, err = _post_error(plain.url, {"prompt": [1]})
        assert code == 404 and "not enabled" in err["error"]
    finally:
        plain.drain()


def test_http_decode_fault_ends_only_its_stream_with_an_error_line(pairs):
    _, tnet = pairs["lstm"]
    server = tnet.serve(port=0, generate=True, gen_slots=2, gen_max_seq=32,
                        gen_prompt_buckets=(8,))
    try:
        faults.arm("decode.step", "raise", nth=3)
        status, lines = _post_generate(server.url, {"prompt": [1],
                                                    "max_new_tokens": 10})
        assert status == 200
        assert lines[-1]["done"] is True and "error" in lines[-1]
        faults.disarm()
        status, lines = _post_generate(server.url, {"prompt": [2],
                                                    "max_new_tokens": 4})
        assert status == 200 and lines[-1]["tokens"] == 4
    finally:
        server.drain()


# -- CLI --------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lstm_checkpoint(tmp_path_factory, pairs):
    jnet, _ = pairs["lstm"]
    path = str(tmp_path_factory.mktemp("gen") / "ckpt")
    jax_checkpoint.save(path, jnet.params, conf=jnet.conf)
    return path


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_cli_generate_prints_jax_keys_and_tokens(lstm_checkpoint, capsys,
                                                 temperature):
    argv = ["generate", "--model", lstm_checkpoint, "--prompt", "1,2,3",
            "--max-new-tokens", "6", "--temperature", temperature,
            "--seed", "4", "--max-seq", "16"]
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert torch_main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["tokens"] == want["tokens"] and got["n_tokens"] == 6
    assert got["fresh_compiles"] == 0
    # no store attached: the program counters of the JAX CLI's block, 0
    assert got["disk_cache"] == {k: 0 for k in want["disk_cache"]}


@pytest.mark.parametrize("flag", [["--draft", "x", "--spec-k", "1"],
                                  ["--compile-cache", "x"]])
def test_cli_generate_refuses_unported_flags(lstm_checkpoint, flag, tmp_path,
                                            capsys):
    """Both flags are ported. `--compile-cache` (it exited naming item 11
    before) attaches the persistent store, which the JSON's `disk_cache`
    names. `--draft` (it exited naming item 8 before) with `--spec-k`
    below 2 exits as the JAX CLI does."""
    argv = ["generate", "--model", lstm_checkpoint, "--prompt", "1"] + flag
    if flag[0] == "--compile-cache":
        argv[-1] = str(tmp_path / "cc")
        assert torch_main(argv + ["--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got["disk_cache"]["dir"] == argv[-1]
        assert got["fresh_compiles"] == 0
        return
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        torch_main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) == \
        "--gen-draft requires --gen-spec-k >= 2"


@pytest.mark.parametrize("flag", [["--gen-spec-k", "3"],
                                  ["--gen-draft", "x"]])
def test_cli_serve_refuses_unported_generation_flags(lstm_checkpoint, flag,
                                                     capsys, monkeypatch):
    """The speculative flags of `serve` are ported (they exited naming
    ROADMAP.md queue A item 8 before): `--gen-draft` without
    `--gen-spec-k >= 2` exits as the JAX CLI does, and `--gen-spec-k`
    without a draft serves, its warm-up reporting spec_k 0 as the JAX
    package's does (the server stops at once here)."""
    from deeplearning4j_tpu_torch.serving.server import ModelServer

    argv = ["serve", "--model", lstm_checkpoint, "--generate", "--port",
            "0"] + flag
    if flag[0] == "--gen-draft":
        with pytest.raises(SystemExit) as want:
            jax_main(argv)
        with pytest.raises(SystemExit) as got:
            torch_main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value) == \
            "--gen-draft requires --gen-spec-k >= 2"
        return
    monkeypatch.setattr(ModelServer, "wait_for_stop", lambda self: None)
    assert torch_main(argv + ["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["generation"]["spec_k"] == 0
    # the predict bucket of the default --shapes 64 (captured before the
    # socket opens, as in the JAX CLI), the decode table and a bucket
    assert lines[0]["warmed"] == [[64, 13]]
    assert lines[0]["fresh_compiles"] == 3
    assert lines[-1]["drained"] is True


@pytest.mark.parametrize("flags", [["--page-size", "4"], ["--prefix-cache"],
                                   ["--steps-per-dispatch", "2"],
                                   ["--steps-per-dispatch", "4",
                                    "--page-size", "4", "--prefix-cache"]],
                         ids=["page_size", "prefix_cache",
                              "steps_per_dispatch", "all"])
def test_cli_generate_options_print_the_jax_clis_tokens(lstm_checkpoint,
                                                        capsys, flags):
    argv = ["generate", "--model", lstm_checkpoint, "--prompt", "1,2,3",
            "--max-new-tokens", "9", "--temperature", "0.8", "--seed", "4",
            "--max-seq", "16"] + flags
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert torch_main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["tokens"] == want["tokens"] and got["n_tokens"] == 9
    assert got["fresh_compiles"] == 0


@pytest.mark.parametrize("flags", [
    ["--gen-page-size", "4", "--gen-pages", "6"],
    ["--gen-prefix-cache", "--gen-prefix-match", "longest"],
    ["--gen-steps-per-dispatch", "4"]],
    ids=["paged", "prefix", "steps_per_dispatch"])
def test_cli_serve_generation_options_stream_jax_tokens(pairs,
                                                        lstm_checkpoint,
                                                        tmp_path, flags):
    """`serve --generate` with the ported options: warmed before the socket
    opens, POST /v1/generate streams JAX's tokens twice (a prefix hit the
    second time), no program is made under traffic, SIGTERM drains."""
    import os
    import signal
    import subprocess
    import sys

    jnet, _ = pairs["lstm"]
    want, _ = _jax_tokens(jnet, [1, 2, 3], 6, temperature=0.8, rng_seed=3)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
         "--model", lstm_checkpoint, "--device", "cpu", "--generate",
         "--gen-slots", "2", "--gen-max-seq", "16"] + flags,
        stdout=subprocess.PIPE, text=True, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=repo))
    try:
        startup = json.loads(proc.stdout.readline())
        warmed = startup["fresh_compiles"]
        for _ in range(2):
            status, lines = _post_generate(startup["url"], {
                "prompt": [1, 2, 3], "max_new_tokens": 6,
                "temperature": 0.8, "rng_seed": 3})
            assert status == 200
            assert [x["token"] for x in lines[:-1]] == want
        with urllib.request.urlopen(startup["url"] + "/v1/stats") as resp:
            gen = json.loads(resp.read())["generation"]
        assert gen["fresh_compiles"] == warmed
        if "--gen-prefix-cache" in flags:
            assert gen["prefix_cache"]["hits"] == 1
        if "--gen-page-size" in flags:
            assert gen["kv_pages"]["total"] == 6
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert json.loads(out.strip().splitlines()[-1])["drained"]


# -- on the card -------------------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the decode graph and the flash "
                    "kernel have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_cuda_captured_decode_equals_the_eager_loop(model):
    """(a): the captured prefill + decode graphs and the eager
    `nn/decode.py` loop give the same tokens and keys, logp within 1e-6
    (f32)."""
    _cuda_or_skip()
    jconf = _jax_conf(model)
    net = ml.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()), device="cuda",
        seed=0).init()
    ic = net.infer_cache
    prompt = np.zeros((1, 8), np.int32)
    prompt[0, :3] = [1, 2, 3]
    for temp in (0.0, 0.8):
        temps = torch.full((1,), temp, device="cuda")
        keys = nd_random.prng_key(5, "cuda")[None]
        state = ic.init_decode_state(net.conf, 1, 16, "cuda")
        eager = decode.init_state(net.conf, 1, 16, "cuda")
        tok, k1, state = ic.prefill(net.conf, net.params, state, prompt,
                                    np.asarray([3], np.int32), keys, temps)
        with torch.inference_mode():
            logp, eager = decode.prefill(
                net.conf, net.params, eager, torch.as_tensor(
                    prompt, device="cuda"),
                torch.as_tensor([3], device="cuda"))
            etok, ek = nd_random.sample_tokens(logp, keys, temps)
        assert torch.equal(tok, etok) and torch.equal(k1, ek)
        pos = np.asarray([3], np.int32)
        for _ in range(6):
            tok, k1, state = ic.decode(net.conf, net.params, state, tok,
                                       pos, k1, temps)
            with torch.inference_mode():
                logp, eager = decode.decode_step(
                    net.conf, net.params, eager, etok,
                    torch.as_tensor(pos, device="cuda"))
                etok, ek = nd_random.sample_tokens(logp, ek, temps)
            assert torch.equal(tok, etok) and torch.equal(k1, ek)
            pos = pos + 1
        for a, b in zip(tree_leaves(state), tree_leaves(eager)):
            assert (a.float() - b.float()).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4, 8, 64, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_forward_at_prefill_buckets_equals_plain(s, dtype):
    """(c): the flash forward kernel at B = 1, S = a prompt bucket, causal,
    on the qkv views of one projection, against its plain version: 2e-2 of
    max|o| in bf16, 1e-4 in f32."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(s)
    h, d = 16, 128
    qkv = torch.randn((1, s, 3 * h * d), generator=gen, device="cuda").to(dt)
    q, k, v = (t.view(1, s, h, d) for t in qkv.split(h * d, dim=-1))
    kernels.reset_launches()
    got = kernels.flash_attention(q, k, v, causal=True)
    assert kernels.LAUNCHES["flash_attn_fwd"] == 1
    want = kernels.flash_attention_reference(q, k, v, causal=True)
    err = (got.float() - want.float()).abs().max().item()
    tol = 2e-2 * want.float().abs().max().item() if dtype == "bfloat16" \
        else 1e-4
    assert err <= tol

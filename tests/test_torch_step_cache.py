"""The port's train-step cache vs the JAX package's.

On the CPU the cache runs its program eagerly, with the keys, buckets,
padding and books of the CUDA path, so these tests hold all of that to the
JAX package's `TrainStepCache`: the same hits and misses over the same
batch stream, the same fingerprints, and params allclose (f32, 1e-5) after
a cached `fit` with a ragged tail. Inputs and weights come from numpy seeds
and cross as numpy arrays. The CUDA-graph path itself runs on the card
(`-m cuda`). No test asserts a bitwise pad-tail property: the reference's
own such tests fail (ROADMAP.md queue C).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.optimize import step_cache as jax_step_cache  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import step_cache  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402

VOCAB, SEQ = 20, 6
D_MODEL = 8


def _confs(model, iterations=1):
    """(JAX conf, port conf) of a small zoo char model: the charTransformer
    (one block, dense attention on both sides, Adam, the fused attention
    backward flag set) or the char-LSTM (embedding, two LSTMs, SGD with
    momentum)."""
    if model == "transformer":
        jconf = jax_zoo.char_transformer(
            VOCAB, d_model=D_MODEL, n_blocks=1, n_heads=2, max_seq_len=SEQ,
            iterations=iterations, sparse_labels=True,
            attention_fused_bwd=True)
        jconf = jconf.replace(confs=tuple(c.replace(attention_impl="full")
                                          for c in jconf.confs))
    else:
        jconf = jax_zoo.char_lstm(VOCAB, hidden=8, n_layers=2,
                                  sparse_labels=True, embed=6,
                                  iterations=iterations)
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _numpy_params(jconf, seed=0):
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_ml.init_params(jconf, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(seed)
    out = []
    for layer in shapes:
        d = {}
        for name, shape in layer.items():
            x = rng.standard_normal(shape).astype(np.float32)
            d[name] = (1.0 + 0.1 * x if name == "ln_g"
                       else (0.3 if len(shape) == 2 else 0.1) * x)
        out.append(d)
    return tuple(out)


def _batch(seed, rows):
    ids = np.random.RandomState(seed).randint(0, VOCAB, (rows, SEQ + 1))
    return (ids[:, :-1].astype(np.int32),
            ids[:, 1:].reshape(rows * SEQ).astype(np.int32))


def _nets(model, iterations=1, seed=0):
    """A JAX network and a port network (CPU) with the same weights."""
    jconf, tconf = _confs(model, iterations)
    np_params = _numpy_params(jconf, seed)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=0)
    tnet.params = checkpoint.params_from_numpy(np_params, "cpu")
    return jnet, tnet


def _books(cache):
    d = cache.stats.as_dict()
    return {k: d[k] for k in ("hits", "misses", "steps", "entries")}


def _assert_params_close(tnet, jnet, tol, model):
    for layer, (tp, jp) in enumerate(zip(tnet.params, jnet.params)):
        for name in tp:
            got, want = tp[name].numpy(), np.asarray(jp[name])
            if model == "transformer" and name == "bqkv":
                # the key bias shifts every score of a query row alike,
                # which the softmax cancels: its gradient is f32 noise in
                # both packages, and Adam's steps turn noise into moves of
                # up to lr a step (tests/test_torch_training.py); q and v
                # biases are held
                n = D_MODEL
                np.testing.assert_allclose(got[:n], want[:n], rtol=tol,
                                           atol=tol)
                np.testing.assert_allclose(got[2 * n:], want[2 * n:],
                                           rtol=tol, atol=tol)
                continue
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=f"layer {layer} {name}")


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    yield
    faults.reset()


def test_four_equal_batches_capture_once_and_hit_three_times():
    jnet, tnet = _nets("lstm")
    for i in range(4):
        x, y = _batch(i, 4)
        jnet.fit(x, y)
        tnet.fit(x, y)
    assert _books(tnet.step_cache) == {"hits": 3, "misses": 1, "steps": 4,
                                       "entries": 1}
    assert _books(tnet.step_cache) == _books(jnet.step_cache)
    assert tnet.step_cache.buckets == jnet.step_cache.buckets == (4,)


def test_a_mixed_epoch_captures_at_most_one_program_a_bucket():
    jnet, tnet = _nets("lstm")
    for i, rows in enumerate((2, 4, 3, 4, 1, 2)):
        x, y = _batch(10 + i, rows)
        jnet.fit(x, y)
        tnet.fit(x, y)
    assert tnet.step_cache.buckets == jnet.step_cache.buckets == (2, 4)
    assert tnet.step_cache.stats.misses == len(tnet.step_cache.buckets)
    assert len(tnet.step_cache) == len(tnet.step_cache.buckets)
    assert _books(tnet.step_cache) == _books(jnet.step_cache)


def test_a_conf_change_is_a_new_key_and_fingerprints_equal_jax():
    for model in ("transformer", "lstm"):
        jconf, tconf = _confs(model)
        assert (step_cache.conf_fingerprint(tconf)
                == jax_step_cache.conf_fingerprint(jconf))
    jnet, tnet = _nets("lstm")
    x, y = _batch(20, 3)
    tnet.fit(x, y)
    faster = tnet.conf.replace(confs=tuple(c.replace(lr=0.5)
                                           for c in tnet.conf.confs))
    assert (step_cache.conf_fingerprint(faster)
            != step_cache.conf_fingerprint(tnet.conf))
    tnet.conf = faster
    tnet.fit(x, y)
    tnet.fit(x, y)
    assert _books(tnet.step_cache) == {"hits": 1, "misses": 2, "steps": 3,
                                       "entries": 2}
    assert step_cache.arg_signature(
        torch.zeros(2, 3, dtype=torch.int32), None,
        torch.zeros(4, dtype=torch.bfloat16)) == \
        jax_step_cache.arg_signature(
            jnp.zeros((2, 3), jnp.int32), None, jnp.zeros(4, jnp.bfloat16))


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("model", ["transformer", "lstm"])
def test_cached_fit_with_a_ragged_tail_matches_jax(model, iterations):
    # three batches, the last ragged: it pads into the full batches'
    # bucket with zero-weight rows in both packages. Three iterations
    # unroll Adam's bias corrections (t = 1, 2, 3) and the momentum
    # schedule into the program, which restarts at iteration 0 each batch
    jnet, tnet = _nets(model, iterations, seed=1)
    stream = [_batch(30, 4), _batch(31, 4), _batch(32, 3)]
    jnet.fit(stream)
    tnet.fit(stream)
    assert tnet.step_cache.buckets == (4,)
    assert _books(tnet.step_cache) == _books(jnet.step_cache)
    _assert_params_close(tnet, jnet, 1e-5, model)
    x, y = _batch(33, 4)
    np.testing.assert_allclose(tnet.score(x, y), float(jnet.score(x, y)),
                               rtol=1e-5, atol=1e-5)


def test_use_step_cache_false_is_the_eager_path_of_both_packages():
    jnet, tnet = _nets("transformer", iterations=2, seed=2)
    jnet.use_step_cache = tnet.use_step_cache = False
    stream = [_batch(40, 3), _batch(41, 2)]
    jnet.fit(stream)
    tnet.fit(stream)
    assert _books(tnet.step_cache) == {"hits": 0, "misses": 0, "steps": 0,
                                       "entries": 0}
    _assert_params_close(tnet, jnet, 1e-5, "transformer")
    # and the cached path agrees with the eager one
    cached = _nets("transformer", iterations=2, seed=2)[1]
    cached.fit(stream)
    _assert_params_close(cached, jnet, 1e-5, "transformer")


def test_the_cached_step_writes_the_networks_params_in_place():
    _, tnet = _nets("lstm", seed=3)
    before = [t for t in tree_leaves(tnet.params)]
    values = [t.clone() for t in before]
    tnet.fit(*_batch(50, 4))
    after = tree_leaves(tnet.params)
    assert all(a is b for a, b in zip(after, before))
    assert any(not torch.equal(a, v) for a, v in zip(after, values))


def test_warmup_captures_ahead_of_the_first_call():
    _, tnet = _nets("lstm", seed=4)
    x, y = _batch(60, 4)
    summary = tnet.warmup([x], entries=("output", "loss"), train=True)
    assert summary["shapes"] == [(4, SEQ)]
    assert summary["step_cache"]["misses"] == 1
    assert summary["infer_cache"]["misses"] == 2
    # the train warm-up took no step
    want = [t.clone() for t in tree_leaves(tnet.params)]
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(tnet.params), want))
    tnet.output(x)
    tnet.score(x, y)
    tnet.fit(x, y)
    assert tnet.step_cache.stats.hits == 1
    assert tnet.infer_cache.stats.hits == 2


def test_an_armed_compile_fault_fires_at_a_new_program_only():
    _, tnet = _nets("lstm", seed=5)
    x, y = _batch(70, 4)
    faults.arm("compile", nth=1)
    with pytest.raises(faults.FaultInjected):
        tnet.fit(x, y)
    tnet.fit(x, y)  # the fault fired once; the program is made now
    tnet.fit(x, y)  # a hit: no new program, no traversal
    assert faults.hits("compile") == 2
    assert _books(tnet.step_cache)["hits"] == 1


def test_out_of_vocab_ids_are_refused_before_a_program_runs():
    _, tnet = _nets("lstm", seed=6)
    x, y = _batch(80, 2)
    x[1, 2] = VOCAB
    with pytest.raises(ValueError, match="token ids"):
        tnet.fit(x, y)
    assert tnet.step_cache.stats.misses == 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["transformer", "lstm"])
def test_cuda_captured_step_replays_its_kernels_and_matches_eager(model):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    from deeplearning4j_tpu_torch.nd import kernels

    jconf, tconf = _confs(model)
    if model == "transformer":
        tconf = tconf.replace(confs=tuple(c.replace(attention_impl="flash")
                                          for c in tconf.confs))
    np_params = _numpy_params(jconf, seed=7)
    nets = {}
    for cached in (True, False):
        net = ml.MultiLayerNetwork(tconf, device="cuda", seed=0)
        net.params = checkpoint.params_from_numpy(np_params, "cuda")
        net.use_step_cache = cached
        nets[cached] = net
    stream = [_batch(90 + i, 4) for i in range(3)]
    per_step = None
    for x, y in stream:
        for cached, net in nets.items():
            kernels.reset_launches()
            net.fit(x, y)
            torch.cuda.synchronize()
            if cached:
                if per_step is not None:
                    assert kernels.LAUNCHES == per_step
                per_step = dict(kernels.LAUNCHES)
    name = "flash_attn_fwd" if model == "transformer" else "lstm_cell"
    assert per_step[name] > 0
    assert _books(nets[True].step_cache) == {"hits": 2, "misses": 1,
                                             "steps": 3, "entries": 1}
    for a, b in zip(tree_leaves(nets[True].params),
                    tree_leaves(nets[False].params)):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            b.abs().max().item(), 1.0)


@pytest.mark.cuda
def test_cuda_a_failed_capture_raises_and_never_runs_eagerly(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    jconf, tconf = _confs("lstm")
    net = ml.MultiLayerNetwork(tconf, device="cuda", seed=0).init()
    before = [t.clone() for t in tree_leaves(net.params)]
    real = step_cache._finetune_program

    def reads_back(conf):
        program = real(conf)

        def run(params, x, y, w):
            new, scores = program(params, x, y, w)
            float(scores[0])  # a host read-back: illegal inside a capture
            return new, scores

        return run

    monkeypatch.setattr(step_cache, "_finetune_program", reads_back)
    with pytest.raises(step_cache.GraphCaptureError):
        net.fit(*_batch(100, 4))
    # nothing ran in its place: no step, params as they were
    assert net.step_cache.stats.steps == 0
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(net.params), before))
    # and the next capture of a sound program succeeds
    monkeypatch.setattr(step_cache, "_finetune_program", real)
    net.fit(*_batch(100, 4))
    assert net.step_cache.stats.steps == 1

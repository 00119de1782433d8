"""The port's inference cache vs the JAX package's.

`output`, `feed_forward` and `score` of batched input go through the
network's `InferCache`: on the CPU its program runs eagerly with the keys,
buckets and padding of the CUDA path, so these tests hold answers (f32,
1e-5) and books to the JAX package's `InferCache` on the same calls, and
show that training between two cached calls is seen by the second. The
CUDA-graph path itself runs on the card (`-m cuda`). Inputs and weights
come from numpy seeds. No test asserts the padded tail's bitwise property,
which the reference's own test fails (ROADMAP.md queue C).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.optimize import infer_cache as jax_infer_cache  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import infer_cache  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402

VOCAB, SEQ = 20, 6


def _confs(model):
    if model == "transformer":
        jconf = jax_zoo.char_transformer(
            VOCAB, d_model=8, n_blocks=1, n_heads=2, max_seq_len=SEQ,
            sparse_labels=True, attention_fused_bwd=True)
        jconf = jconf.replace(confs=tuple(c.replace(attention_impl="full")
                                          for c in jconf.confs))
    else:
        jconf = jax_zoo.char_lstm(VOCAB, hidden=8, n_layers=2,
                                  sparse_labels=True, embed=6)
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _nets(model, seed=0):
    jconf, tconf = _confs(model)
    np_params = tuple(
        {k: np.asarray(v) for k, v in layer.items()}
        for layer in jax_ml.init_params(jconf, jax.random.PRNGKey(seed)))
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=0)
    tnet.params = checkpoint.params_from_numpy(np_params, "cpu")
    return jnet, tnet


def _batch(seed, rows):
    ids = np.random.RandomState(seed).randint(0, VOCAB, (rows, SEQ + 1))
    return (ids[:, :-1].astype(np.int32),
            ids[:, 1:].reshape(rows * SEQ).astype(np.int32))


def _books(cache):
    d = cache.stats.as_dict()
    return {k: d[k] for k in ("hits", "misses", "steps", "entries")}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("model", ["transformer", "lstm"])
def test_cached_entry_points_answer_and_keep_books_as_jax(model):
    # a full batch, then a ragged one that pads into its bucket, then a
    # larger one (a new bucket): both packages key, pad and count alike
    jnet, tnet = _nets(model, seed=1)
    for i, rows in enumerate((4, 3, 6)):
        x, y = _batch(i, rows)
        got = tnet.output(x)
        assert got.shape == (rows * SEQ, VOCAB)
        _close(got, jnet.output(x))
        acts, jacts = tnet.feed_forward(x), jnet.feed_forward(x)
        assert len(acts) == len(jacts)
        for a, b in zip(acts, jacts):
            _close(a, b)
        np.testing.assert_allclose(tnet.score(x, y), float(jnet.score(x, y)),
                                   rtol=1e-5, atol=1e-5)
    assert tnet.infer_cache.buckets == jnet.infer_cache.buckets == (4, 6)
    assert _books(tnet.infer_cache) == _books(jnet.infer_cache) == {
        "hits": 3, "misses": 6, "steps": 9, "entries": 6}


def test_pad_and_truncate_rows_equal_jax():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    got = infer_cache.pad_rows(torch.from_numpy(x), 4)
    want = jax_infer_cache.pad_rows(jnp.asarray(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # B*T rows of a sequence head, rows tied to the batch, and rows not
    for shape in ((4 * SEQ, 7), (4, 7), (5, 7)):
        a = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            infer_cache.truncate_rows(torch.from_numpy(a), 4, 3).numpy(),
            np.asarray(jax_infer_cache.truncate_rows(jnp.asarray(a), 4, 3)))


def test_the_infer_fingerprint_ignores_the_fused_backward_flag_as_jax():
    jconf, tconf = _confs("transformer")
    off = tconf.replace(confs=tuple(c.replace(attention_fused_bwd=False)
                                    for c in tconf.confs))
    ours, theirs = infer_cache.InferCache(), jax_infer_cache.InferCache()
    assert ours._fingerprint(tconf) == ours._fingerprint(off) == \
        theirs._fingerprint(jconf)


@pytest.mark.parametrize("model", ["transformer", "lstm"])
def test_training_between_two_cached_outputs_is_seen_by_the_second(model):
    jnet, tnet = _nets(model, seed=3)
    x, y = _batch(10, 4)
    first = tnet.output(x)
    for net in (jnet, tnet):
        net.fit(x, y)
    second = tnet.output(x)
    assert not torch.equal(first, second)
    _close(second, jnet.output(x))
    with torch.inference_mode():
        _close(second, ml.network_output(tnet.conf, tnet.params,
                                         torch.from_numpy(x)), 1e-6)
    assert _books(tnet.infer_cache)["misses"] == 1
    # assigning another params tree: the next call reads the new one
    tnet.params = tuple({k: v * 0.5 for k, v in layer.items()}
                        for layer in tnet.params)
    with torch.inference_mode():
        _close(tnet.output(x), ml.network_output(
            tnet.conf, tnet.params, torch.from_numpy(x)), 1e-6)


def test_use_infer_cache_false_and_unbatched_input_run_eagerly():
    jnet, tnet = _nets("lstm", seed=4)
    x, y = _batch(20, 3)
    jnet.use_infer_cache = tnet.use_infer_cache = False
    _close(tnet.output(x), jnet.output(x))
    np.testing.assert_allclose(tnet.score(x, y), float(jnet.score(x, y)),
                               rtol=1e-5, atol=1e-5)
    jnet.use_infer_cache = tnet.use_infer_cache = True
    _close(tnet.output(x[0]), jnet.output(x[0]))  # one [T] sequence
    assert _books(tnet.infer_cache) == _books(jnet.infer_cache) == {
        "hits": 0, "misses": 0, "steps": 0, "entries": 0}


def test_cached_output_refuses_out_of_vocab_ids_on_the_host():
    _, tnet = _nets("transformer", seed=5)
    x, _ = _batch(30, 2)
    x[0, 0] = -1
    with pytest.raises(ValueError, match="token ids"):
        tnet.output(x)
    assert tnet.infer_cache.stats.misses == 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["transformer", "lstm"])
def test_cuda_cached_output_replays_its_kernels_and_returns_copies(model):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    from deeplearning4j_tpu_torch.nd import kernels

    jconf, tconf = _confs(model)
    if model == "transformer":
        tconf = tconf.replace(confs=tuple(c.replace(attention_impl="flash")
                                          for c in tconf.confs))
    net = ml.MultiLayerNetwork(tconf, device="cuda", seed=0).init()
    x, y = _batch(40, 4)
    kernels.reset_launches()
    first = net.output(x)
    once = dict(kernels.LAUNCHES)
    second = net.output(_batch(41, 3)[0])
    assert first.data_ptr() != second.data_ptr()
    kernels.reset_launches()
    again = net.output(x)
    assert kernels.LAUNCHES == once
    assert torch.equal(first, again)
    name = "flash_attn_fwd" if model == "transformer" else "lstm_cell"
    assert once[name] > 0
    net.use_infer_cache = False
    eager = net.output(x)
    assert (again - eager).abs().max().item() <= 1e-5
    assert _books(net.infer_cache) == {"hits": 2, "misses": 1, "steps": 3,
                                       "entries": 1}

"""Dropout under training in the port vs the JAX package: the threefry
masks bit for bit, the key discipline of the layers (input dropout,
drop-connect, attention and FFN branch dropout), of the losses (one key a
layer), of the solver (one split an iteration) and of `MultiLayerNetwork`
(one key for `init`, one a `finetune`), and a resumed checkpointed `fit`.

Inputs and weights come from numpy seeds or JAX's init, carried across
with `params_from_numpy`. Tolerances: masks bitwise; losses and outputs
1e-5; gradients 1e-4; `fit` params 1e-5; a resumed fit bitwise one run.
"""

import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nd import random as jax_random  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu_torch.datasets import mnist as port_mnist  # noqa: E402,E501
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import solver  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import TrainingInterrupted  # noqa: E402,E501


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, nd_random.key_array(np.asarray(k))


# ------------------------------------------------------------------- masks

@pytest.mark.parametrize("shape", [(7, 5), (16, 800), (3, 4, 5, 6),
                                   (2, 20, 12, 12)])
@pytest.mark.parametrize("keep", [0.5, 0.9, 0.3])
def test_dropout_mask_and_bernoulli_equal_jax_bitwise(shape, keep):
    for seed in (0, 3, 2 ** 31 + 5):
        jk, tk = _key(seed)
        want = np.asarray(jax.random.bernoulli(jk, keep, shape))
        got = nd_random.bernoulli(tk, keep, shape)
        assert got.dtype == torch.bool and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jax_random.dropout_mask(jk, keep, shape, jdt)
                              .astype(jnp.float32))
            got = nd_random.dropout_mask(tk, keep, shape, tdt)
            assert got.dtype == tdt
            np.testing.assert_array_equal(got.float().numpy(), want)


def test_binomial_normal_and_keystream_match_jax():
    jk, tk = _key(7)
    np.testing.assert_array_equal(
        nd_random.binomial(tk, 0.25, (6, 9)).numpy(),
        np.asarray(jax_random.binomial(jk, 0.25, (6, 9))))
    _close(nd_random.normal(tk, 0.5, 2.0, (4, 50)),
           jax_random.normal(jk, 0.5, 2.0, (4, 50)), 1e-5)
    js, ts = jax_random.KeyStream(11), nd_random.KeyStream(11)
    for _ in range(4):
        np.testing.assert_array_equal(ts().numpy(),
                                      np.asarray(js()).astype(np.int64))
    key = (0, 99)
    for _ in range(3):
        # the host split on ints equals the tensor split
        assert [list(k) for k in nd_random.split_host(key, 3)] == \
            nd_random.split(torch.tensor(key), 3).tolist()
        key, sub = nd_random.split_host(key)
    jkey = jax.random.PRNGKey(99)
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
    assert list(key) == np.asarray(jkey).tolist()
    assert list(sub) == np.asarray(jsub).tolist()


# ---------------------------------------------------------------- networks

def _lenet(dropout=0.5, drop_connect=False, dense_only=True):
    jconf = jax_zoo.lenet5()
    confs = tuple(c.replace(dropout=dropout, drop_connect=drop_connect)
                  if (i == 4 or not dense_only) else c
                  for i, c in enumerate(jconf.confs))
    jconf = jconf.replace(confs=confs)
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _digits(n, seed=0):
    x, y = port_mnist.synthetic_mnist(n + seed)
    x = (x[seed:seed + n] > 30.0 / 255.0).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[y[seed:seed + n]]


def _jax_params(jconf, seed=0):
    return jax.device_get(jax_ml.init_params(jconf,
                                             jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dropout,drop_connect,dense_only", [
    (0.5, False, True), (0.0, True, True), (0.3, True, False)])
def test_lenet_loss_and_grads_with_dropout_equal_jax(dropout, drop_connect,
                                                     dense_only):
    """LeNet with dropout 0.5 on its dense layer, drop-connect there, and
    both on the dense and output layers (the conv layers draw nothing):
    the loss on one key equals JAX's (1e-5), the gradients 1e-4."""
    jconf, tconf = _lenet(dropout, drop_connect, dense_only)
    np_p = _jax_params(jconf, seed=1)
    x, y = _digits(8, seed=1)
    jk, tk = _key(21)
    want_loss, want_g = jax.value_and_grad(
        lambda p: jax_ml.network_loss(jconf, p, jnp.asarray(x),
                                      jnp.asarray(y), jk))(
        jax.tree_util.tree_map(jnp.asarray, np_p))
    got_g, got_loss = solver.from_loss(
        lambda p, k: ml.network_loss(tconf, p, torch.from_numpy(x),
                                     torch.from_numpy(y), k),
        with_key=True).grad_and_score(
        checkpoint.params_from_numpy(np_p, "cpu"), tk)
    _close(got_loss, want_loss, 1e-5)
    for g, w in zip(tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)):
        _close(g, w, 1e-4)
    # the masks matter: another key gives another loss
    other = ml.network_loss(tconf, checkpoint.params_from_numpy(np_p, "cpu"),
                            torch.from_numpy(x), torch.from_numpy(y),
                            _key(22)[1])
    assert abs(float(other) - float(got_loss)) > 1e-4


def test_feed_forward_drops_only_under_training_with_a_key():
    jconf, tconf = _lenet(0.5)
    np_p = _jax_params(jconf, seed=2)
    tp = checkpoint.params_from_numpy(np_p, "cpu")
    x, _ = _digits(4, seed=3)
    jk, tk = _key(5)
    for training in (True, False):
        want = jax_ml.feed_forward(jconf, np_p, jnp.asarray(x), jk,
                                   training=training)
        got = ml.feed_forward(tconf, tp, torch.from_numpy(x), tk,
                              training=training)
        for a, b in zip(got, want):
            _close(a, b, 1e-5)
    plain = ml.network_output(tconf, tp, torch.from_numpy(x))
    _close(ml.network_output(tconf, tp, torch.from_numpy(x), tk), plain, 0)
    _close(ml.network_output(tconf, tp, torch.from_numpy(x), None,
                             training=True), plain, 0)


def test_transformer_attention_and_ffn_dropout_equal_jax():
    jconf = jax_zoo.char_transformer(20, d_model=16, n_blocks=2, n_heads=2,
                                     max_seq_len=8, sparse_labels=True)
    jconf = jconf.replace(confs=tuple(
        c.replace(dropout=0.3, attention_impl="full") for c in jconf.confs))
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    np_p = _jax_params(jconf, seed=3)
    ids = np.random.RandomState(4).randint(0, 20, (3, 9))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].reshape(-1).astype(
        np.int32)
    jk, tk = _key(8)
    want = jax_ml.network_loss(jconf, np_p, jnp.asarray(x), jnp.asarray(y),
                               jk)
    got = ml.network_loss(tconf, checkpoint.params_from_numpy(np_p, "cpu"),
                          torch.from_numpy(x), torch.from_numpy(y), tk)
    _close(got, want, 1e-5)
    no_drop = ml.network_loss(tconf, checkpoint.params_from_numpy(np_p,
                                                                  "cpu"),
                              torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(no_drop) - float(got)) > 1e-4


# ---------------------------------------------------------------- training

def _fit_both(jconf, tconf, batches, cached, seed):
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=seed).init()
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=seed).init()
    tnet.params = checkpoint.params_from_numpy(jax.device_get(jnet.params),
                                               "cpu")
    jnet.use_step_cache = tnet.use_step_cache = cached
    jnet.fit(list(batches))
    tnet.fit(list(batches))
    return jnet, tnet


@pytest.mark.parametrize("cached", [True, False])
def test_three_batch_fit_with_dropout_follows_jaxs_key_stream(cached):
    """`MultiLayerNetwork(conf, seed=s)`, JAX's initial params carried in,
    three `fit` batches with dropout 0.5 on LeNet's dense layer and 2
    iterations a batch: params within 1e-5 of JAX's. Init's key, one key a
    batch and one split an iteration all line up with JAX's stream, or the
    masks would differ."""
    jconf, tconf = _lenet(0.5)
    jconf = jconf.replace(confs=tuple(c.replace(num_iterations=2)
                                      for c in jconf.confs))
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    x, y = _digits(36, seed=5)
    batches = [(x[i:i + 12], y[i:i + 12]) for i in (0, 12, 24)]
    jnet, tnet = _fit_both(jconf, tconf, batches, cached, seed=17)
    for a, b in zip(tree_leaves(tnet.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        _close(a, b, 1e-5)
    assert list(tnet._key) == np.asarray(jnet._key).tolist()


def test_no_key_reaches_the_device_without_dropout():
    """A conf that drops nothing passes no key to the step (no split, no
    key input), yet its stream advances as JAX's does."""
    jconf, tconf = _lenet(0.0)
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=3).init()
    assert not ml.uses_key(tconf) and ml.uses_key(_lenet(0.5)[1])
    x, y = _digits(8)
    tnet.fit(x, y)
    (key,) = [k for k in tnet.step_cache._programs]
    assert len(key[3]) == 3  # (x, y, w): no key tensor
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=3).init()
    jnet._next_key()
    assert list(tnet._key) == np.asarray(jnet._key).tolist()


class _SigtermAfter:
    def __init__(self, after):
        self.after, self.n = after, 0

    def iteration_done(self, model, iteration, score):
        self.n += 1
        if self.n == self.after:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)


def test_resumed_checkpointed_fit_with_dropout_equals_one_run(tmp_path):
    """SIGTERM after 2 of 4 batches, then a fresh net on the same stream:
    it restores `rng_key` (JAX's name for it) with the params, so its masks
    continue the stream and it ends bitwise equal to one uninterrupted
    run; the saved key is JAX's key after the same batches."""
    jconf, tconf = _lenet(0.5)
    x, y = _digits(32, seed=6)
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]

    def net():
        return ml.MultiLayerNetwork(tconf, device="cpu", seed=9).init()

    ref = net()
    ref.fit(list(batches))
    ck = str(tmp_path / "ck")
    first = net()
    first.set_listeners([_SigtermAfter(2)])
    with pytest.raises(TrainingInterrupted):
        first.fit(list(batches), checkpoint_dir=ck)
    _, _, meta = checkpoint.load(ck)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=9).init()
    jnet._next_key()
    jnet._next_key()
    assert meta["metadata"]["rng_key"] == np.asarray(jnet._key).tolist()
    second = net()
    second.fit(list(batches), checkpoint_dir=ck)
    assert second.resumed_from_batch == 2
    for a, b in zip(tree_leaves(second.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)
    # without the key the rerun would draw other masks
    third = net()
    third.params = tuple({k: v.clone() for k, v in layer.items()}
                         for layer in first.params)
    third.fit(batches[2:])
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(third.params), tree_leaves(ref.params)))

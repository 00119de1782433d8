"""Conv nets in the port vs the JAX package: convolution, pooling,
BatchNorm (training, row-weighted, inference from the EMA), LeNet-5 and the
VGG-style CIFAR-10 net through their forward, loss, BatchNorm statistics
and `fit` (captured-step program and eager path), and the CLI's `--zoo
lenet5` / `--zoo vgg_cifar10`.

Inputs come from numpy seeds, or the MNIST and CIFAR stand-ins; JAX's
params are carried across with `params_from_numpy`. Tolerances: f32 conv
and pooling rtol 1e-5 (pooling exact on the JAX test's input), bf16
operands 2e-2 * max, BatchNorm and network outputs 1e-5, `fit` params and
EMA 1e-5, a padded tail against the unpadded port run 1e-6. The JAX
package reduces with gemm contractions (its `rows_broadcast`), the port
with sums: the two agree to float rounding, never bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.cli.driver import main as jax_main  # noqa: E402
from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.nn.layers import base as jax_base  # noqa: E402
from deeplearning4j_tpu.nn.layers import conv as jax_conv  # noqa: E402
from deeplearning4j_tpu_torch.cli.driver import main  # noqa: E402
from deeplearning4j_tpu_torch.datasets import mnist as port_mnist  # noqa: E402,E501
from deeplearning4j_tpu_torch.datasets.cifar import synthetic_cifar10  # noqa: E402,E501
from deeplearning4j_tpu_torch.models import zoo  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    LayerType, MultiLayerConfiguration, NeuralNetConfiguration, PoolingType)
from deeplearning4j_tpu_torch.nn.layers import conv  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.base import BatchNormLayer  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import solver, updater  # noqa: E402
from deeplearning4j_tpu_torch.optimize.step_cache import TrainStepCache  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel.checkpoint import (  # noqa: E402
    params_from_numpy)


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(jconf):
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _lenet(**kw):
    return _pair(jax_zoo.lenet5(**kw))


def _vgg(width=8, **kw):
    return _pair(jax_zoo.vgg_cifar10(width=width, **kw))


def _np_params(jconf, seed=0, ema=False):
    """JAX's initial params as numpy, with nonzero biases and BatchNorm
    affines (and, with `ema`, a trained-looking EMA)."""
    p = jax.device_get(jax_ml.init_params(jconf, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    out = []
    for layer in p:
        d = {k: np.array(v, np.float32) for k, v in layer.items()}
        for k in ("b", "beta"):
            if k in d:
                d[k] = 0.1 * rng.standard_normal(d[k].shape).astype(
                    np.float32)
        if "gamma" in d:
            d["gamma"] = 1 + 0.1 * rng.standard_normal(
                d["gamma"].shape).astype(np.float32)
        if ema and "ema_w" in d:
            n = d["ema_mean"].shape
            d["ema_mean"] = 0.2 * rng.standard_normal(n).astype(np.float32)
            d["ema_var"] = rng.uniform(0.1, 1.0, n).astype(np.float32)
            d["ema_w"] = np.float32(0.6)
        out.append(d)
    return tuple(out)


def _digits(n, seed=0):
    """n binarized digits of the MNIST stand-in (flat background: the
    pooling windows there hold tied maxima) and one-hot labels."""
    x, y = port_mnist.synthetic_mnist(n + seed)
    x = (x[seed:seed + n] > 30.0 / 255.0).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[y[seed:seed + n]]


def _cifar(n, seed=11):
    x, y = synthetic_cifar10(n, seed=seed)
    return x, np.eye(10, dtype=np.float32)[y]


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("stride,padding", [((1, 1), (0, 0)),
                                            ((2, 2), (1, 1)),
                                            ((1, 2), (2, 1))])
def test_conv2d_f32_matches_jax(stride, padding):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((3, 4, 11, 9)).astype(np.float32)
    w = rng.standard_normal((5, 4, 3, 3)).astype(np.float32)
    want = jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w), stride, padding)
    got = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride,
                      padding)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_conv2d_grads_match_jax():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    g = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jax_conv.conv2d(
        a, b, (1, 1), (1, 1)) * g), argnums=(0, 1))(jnp.asarray(x),
                                                     jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = torch.autograd.grad(
        (conv.conv2d(tx, tw, (1, 1), (1, 1)) * torch.from_numpy(g)).sum(),
        (tx, tw))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


def test_conv2d_bf16_operands_within_2e2_of_max():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 3, 10, 10)).astype(np.float32)
    w = rng.standard_normal((6, 3, 5, 5)).astype(np.float32)
    want = np.asarray(jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                      operand_dtype=jnp.bfloat16))
    got = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      operand_dtype=torch.bfloat16)
    assert got.dtype == torch.float32  # cast back to the param dtype
    assert np.abs(_np(got) - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "none"])
@pytest.mark.parametrize("window,stride", [((2, 2), None), ((3, 3), (2, 2)),
                                           ((2, 3), (1, 2))])
def test_pool2d_matches_jax(kind, window, stride):
    x = np.random.RandomState(3).standard_normal((2, 3, 9, 8)).astype(
        np.float32)
    want = jax_conv.pool2d(jnp.asarray(x), kind, window, stride)
    got = conv.pool2d(torch.from_numpy(x), kind, window, stride)
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def test_pool2d_is_exact_on_the_jax_tests_input():
    """JAX's test_subsampling_layer input (arange(16) as 1x1x4x4)."""
    x = np.arange(16.0, dtype=np.float32).reshape(1, 1, 4, 4)
    c = NeuralNetConfiguration(layer_type=LayerType.SUBSAMPLING,
                               kernel_size=(2, 2), stride=(2, 2),
                               pooling=PoolingType.MAX)
    got = conv.SubsamplingLayer.forward({}, c, torch.from_numpy(x))
    np.testing.assert_array_equal(got[0, 0].numpy(), [[5.0, 7.0],
                                                      [13.0, 15.0]])
    for kind in ("max", "avg", "sum"):
        np.testing.assert_array_equal(
            conv.pool2d(torch.from_numpy(x), kind).numpy(),
            np.asarray(jax_conv.pool2d(jnp.asarray(x), kind)))


def test_convolution_layer_init_and_forward():
    jc = jax_conf.NeuralNetConfiguration(
        layer_type=jax_conf.LayerType.CONVOLUTION, n_channels=3, n_out=4,
        kernel_size=(3, 3), padding=(1, 1), activation="relu")
    tc = NeuralNetConfiguration.from_json(jc.to_json())
    p = conv.ConvolutionLayer.init(nd_random.prng_key(0), tc)
    assert p["W"].shape == (4, 3, 3, 3) and p["b"].shape == (4,)
    r = np.sqrt(6.0 / (3 * 9 + 4 * 9))
    assert float(p["W"].abs().max()) <= r and float(p["b"].abs().max()) == 0
    jp = jax_conv.ConvolutionLayer.init(jax.random.PRNGKey(1), jc)
    jp = {k: np.array(v) for k, v in jp.items()}
    jp["b"] = np.linspace(-0.2, 0.2, 4).astype(np.float32)
    x = np.random.RandomState(4).standard_normal((2, 3, 6, 6)).astype(
        np.float32)
    _close(conv.ConvolutionLayer.forward(
               {k: torch.from_numpy(v) for k, v in jp.items()}, tc,
               torch.from_numpy(x)),
           jax_conv.ConvolutionLayer.forward(jp, jc, jnp.asarray(x)), 1e-5)


def test_cudnn_conv_flags_set_and_restore_the_callers_flags():
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.allow_tf32, cudnn.benchmark)
    cudnn.allow_tf32, cudnn.benchmark = True, True
    try:
        with conv.cudnn_conv_flags():
            assert (cudnn.deterministic, cudnn.allow_tf32,
                    cudnn.benchmark) == (True, False, False)
        assert cudnn.allow_tf32 and cudnn.benchmark
    finally:
        cudnn.deterministic, cudnn.allow_tf32, cudnn.benchmark = before


def _bn_case(ndim, seed=5):
    rng = np.random.RandomState(seed)
    shape = (6, 4, 5, 3) if ndim == 4 else (7, 4)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    p = {"gamma": 1 + 0.2 * rng.standard_normal(4).astype(np.float32),
         "beta": 0.3 * rng.standard_normal(4).astype(np.float32),
         "ema_mean": 0.5 * rng.standard_normal(4).astype(np.float32),
         "ema_var": rng.uniform(0.2, 1.5, 4).astype(np.float32),
         "ema_w": np.float32(0.0)}
    w = np.ones(shape[0], np.float32)
    w[-2:] = 0.0
    return x, p, w


@pytest.mark.parametrize("ndim", [2, 4])
@pytest.mark.parametrize("mode", ["train", "train_weighted", "ema_w_zero",
                                  "ema_w_positive"])
def test_batchnorm_forward_matches_jax(ndim, mode):
    x, p, w = _bn_case(ndim)
    if mode == "ema_w_positive":
        p["ema_w"] = np.float32(0.271)
    jc = jax_conf.NeuralNetConfiguration(
        layer_type=jax_conf.LayerType.BATCH_NORM, n_in=4, n_out=4)
    tc = NeuralNetConfiguration.from_json(jc.to_json())
    training = mode.startswith("train")
    rw = w if mode == "train_weighted" else None
    want = jax_base.BatchNormLayer.forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jc, jnp.asarray(x),
        training=training, row_weights=None if rw is None
        else jnp.asarray(rw))
    got = BatchNormLayer.forward(
        {k: torch.as_tensor(v) for k, v in p.items()}, tc,
        torch.from_numpy(x), training=training,
        row_weights=None if rw is None else torch.from_numpy(rw))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("ndim", [2, 4])
def test_batchnorm_moments_and_init_match_jax(ndim):
    x, _, w = _bn_case(ndim, seed=6)
    for rw in (None, w):
        want = jax_base.BatchNormLayer.moments(
            jnp.asarray(x), None if rw is None else jnp.asarray(rw))
        got = BatchNormLayer.moments(
            torch.from_numpy(x), None if rw is None else torch.from_numpy(rw))
        for a, b in zip(got, want):
            _close(a, b, 1e-5)
        for a, b in zip(BatchNormLayer.stats_of(*got),
                        jax_base.BatchNormLayer.stats_of(*want)):
            _close(a, b, 1e-5)
    jc = jax_conf.NeuralNetConfiguration(
        layer_type=jax_conf.LayerType.BATCH_NORM, n_in=5, n_out=5)
    want = jax_base.BatchNormLayer.init(jax.random.PRNGKey(0), jc)
    got = BatchNormLayer.init(nd_random.prng_key(0),
                              NeuralNetConfiguration.from_json(jc.to_json()))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------- networks

def test_lenet5_output_matches_jax():
    jconf, tconf = _lenet()
    np_p = _np_params(jconf)
    x, _ = _digits(6)
    _close(ml.network_output(tconf, params_from_numpy(np_p, "cpu"),
                             torch.from_numpy(x)),
           jax_ml.network_output(jconf, np_p, jnp.asarray(x)), 1e-5)


def test_vgg_output_matches_jax():
    """Inference reads the bias-corrected EMA in both packages."""
    jconf, tconf = _vgg()
    np_p = _np_params(jconf, seed=1, ema=True)
    x, _ = _cifar(5)
    tp = params_from_numpy(np_p, "cpu")
    _close(ml.network_output(tconf, tp, torch.from_numpy(x)),
           jax_ml.network_output(jconf, np_p, jnp.asarray(x)), 1e-5)
    acts = ml.feed_forward(tconf, tp, torch.from_numpy(x))
    jacts = jax_ml.feed_forward(jconf, np_p, jnp.asarray(x))
    assert len(acts) == len(jacts) == 11
    for a, b in zip(acts, jacts):
        assert tuple(a.shape) == b.shape
        _close(a, b, 1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_vgg_rowwise_loss_and_bn_stats_match_jax(weighted):
    jconf, tconf = _vgg()
    np_p = _np_params(jconf, seed=2)
    x, y = _cifar(6, seed=3)
    rw = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None
    want_rows, want_stats = jax_ml.network_rowwise_loss(
        jconf, np_p, jnp.asarray(x), jnp.asarray(y),
        row_weights=None if rw is None else jnp.asarray(rw),
        return_bn_stats=True)
    rows, stats = ml.network_rowwise_loss(
        tconf, params_from_numpy(np_p, "cpu"), torch.from_numpy(x),
        torch.from_numpy(y),
        row_weights=None if rw is None else torch.from_numpy(rw),
        return_bn_stats=True)
    _close(rows, want_rows, 1e-5)
    assert len(stats) == len(want_stats) == 3
    for got3, want3 in zip(stats, want_stats):
        for a, b in zip(got3, want3):
            # raw sums over 6 x 32 x 32 positions: relative 1e-5
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))


def test_lenet5_grads_on_stand_in_digits_match_jax():
    """The stand-in's flat background gives tied maxima in the pooling
    windows: both packages route each window's gradient to its first
    maximum, so the gradients agree (1e-4, the f32 grad tolerance of
    tests/test_torch_training.py)."""
    jconf, tconf = _lenet()
    np_p = _np_params(jconf, seed=3)
    x, y = _digits(8, seed=2)
    want_loss, want_g = jax.value_and_grad(
        lambda p: jax_ml.network_loss(jconf, p, jnp.asarray(x),
                                      jnp.asarray(y)))(
        jax.tree_util.tree_map(jnp.asarray, np_p))
    got_g, got_loss = solver.from_loss(
        lambda p: ml.network_loss(tconf, p, torch.from_numpy(x),
                                  torch.from_numpy(y))).grad_and_score(
        params_from_numpy(np_p, "cpu"))
    _close(got_loss, want_loss, 1e-5)
    h = np.asarray(jax_ml.feed_forward(jconf, np_p, jnp.asarray(x))[0])
    # the first conv layer's pooling windows do hold ties
    win = h[:, :, :24, :24].reshape(8, 20, 12, 2, 12, 2)
    top = win.max(axis=(3, 5), keepdims=True)
    assert ((win == top).sum(axis=(3, 5)) > 1).mean() > 0.3
    for g, w in zip(tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)):
        _close(g, w, 1e-4)


# ---------------------------------------------------------------- training

def _fit_both(jconf, tconf, batches, cached, seed=0):
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=seed).init()
    jnet.use_step_cache = cached
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=seed).init()
    tnet.params = params_from_numpy(jax.device_get(jnet.params), "cpu")
    tnet.use_step_cache = cached
    jnet.fit(list(batches))
    tnet.fit(list(batches))
    return jnet, tnet


def _assert_params(tnet, jparams, tol):
    for layer, jl in zip(tnet.params, jax.device_get(jparams)):
        assert sorted(layer) == sorted(jl)
        for k in layer:
            _close(layer[k], jl[k], tol)


@pytest.mark.parametrize("cached", [True, False])
def test_lenet5_fit_matches_jax(cached):
    jconf, tconf = _lenet()
    x, y = _digits(32, seed=4)
    batches = [(x[:16], y[:16]), (x[16:], y[16:])]
    jnet, tnet = _fit_both(jconf, tconf, batches, cached)
    _assert_params(tnet, jnet.params, 1e-5)
    assert tnet.step_cache.stats.steps == (2 if cached else 0)


@pytest.mark.parametrize("cached", [True, False])
def test_vgg_fit_with_a_padded_tail_matches_jax(cached):
    """Two batches, the second an 11-row tail (padded into the 16-row
    bucket on the cached path): after each, params and EMA equal JAX's
    within 1e-5. The cached EMA comes from the step's own forward, the
    eager one from a forward after it, in both packages.

    Each batch starts from JAX's params (EMA included, so the EMA still
    accumulates over both): in this tail a first-layer channel is dead
    (relu zero on every row), its BatchNorm variance is ~0, and
    1 / sqrt(var + eps) amplifies rounding ~300-fold, so JAX's own
    gradient moves by 6e-2 when the params move by 2e-6. A two-batch
    trajectory that enters the tail 2e-6 apart leaves it 3e-3 apart on
    the eager path, although every step agrees within 1e-5."""
    jconf, tconf = _vgg()
    x, y = _cifar(27, seed=5)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0).init()
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=0).init()
    jnet.use_step_cache = tnet.use_step_cache = cached
    for sl in (slice(0, 16), slice(16, 27)):
        tnet.params = params_from_numpy(jax.device_get(jnet.params), "cpu")
        jnet.fit(x[sl], y[sl])
        tnet.fit(x[sl], y[sl])
        _assert_params(tnet, jnet.params, 1e-5)
    if cached:
        assert tnet.step_cache.buckets == (16,)
        assert tnet._bn_in_step
    ema_w = float(tnet.params[1]["ema_w"])
    np.testing.assert_allclose(ema_w, 1 - 0.9 ** 2, rtol=1e-6)


def test_vgg_padded_tail_equals_the_unpadded_port_run():
    """The 11-row tail padded into 16 rows trains to the params and EMA of
    the same step on an 11-row bucket within 1e-6: pad rows weigh 0 in the
    loss and in BatchNorm's moments. JAX's own version of this check is
    bitwise and fails on this tree, so nothing here is bitwise."""
    jconf, tconf = _vgg()
    np_p = _np_params(jconf, seed=4)
    x, y = _cifar(11, seed=6)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    runs = []
    for bucket in (16, 11):
        cache = TrainStepCache()
        cache.bucket_rows(bucket)
        params = params_from_numpy(np_p, "cpu")
        scores = cache.finetune(tconf, params, tx, ty)
        runs.append((params, scores))
    (pad, s_pad), (ref, s_ref) = runs
    np.testing.assert_allclose(s_pad, s_ref, rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(pad), tree_leaves(ref)):
        _close(a, b, 1e-6)
    from deeplearning4j_tpu.optimize.step_cache import \
        TrainStepCache as JaxCache

    jcache = JaxCache()
    jcache.bucket_rows(16)
    jp, js = jcache.finetune(jconf, jax.tree_util.tree_map(jnp.asarray, np_p),
                             jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(0))
    np.testing.assert_allclose(s_pad, np.asarray(js), rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(pad), jax.tree_util.tree_leaves(jp)):
        _close(a, b, 1e-5)


def _bn_conf(iters):
    jc = jax_conf
    confs = (
        jc.NeuralNetConfiguration(layer_type=jc.LayerType.BATCH_NORM, n_in=6,
                                  n_out=6),
        jc.NeuralNetConfiguration(
            layer_type=jc.LayerType.OUTPUT, n_in=6, n_out=3,
            num_iterations=iters,
            optimization_algo=jc.OptimizationAlgorithm
            .ITERATION_GRADIENT_DESCENT))
    return _pair(jc.MultiLayerConfiguration(confs=confs))


def test_bn_fit_advances_the_ema_in_the_step_near_the_batch_mean():
    """JAX's test_bn_fit_skips_second_forward_ema_pass: the cached step
    owns the EMA advance, which lands near the batch mean, and equals
    JAX's (the last live iteration's moments, 5 iterations)."""
    jconf, tconf = _bn_conf(iters=5)
    rng = np.random.RandomState(0)
    x = rng.rand(32, 6).astype(np.float32) * 5 + 3
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]
    jnet, tnet = _fit_both(jconf, tconf, [(x, y)], cached=True)
    assert tnet._bn_in_step
    p = tnet.params[0]
    mean = p["ema_mean"].numpy() / max(float(p["ema_w"]), 1e-8)
    assert np.all(np.abs(mean - x.mean(0)) < 0.5)
    _assert_params(tnet, jnet.params, 1e-5)
    # inference now reads the EMA (the infer cache reads the leaves the
    # step wrote)
    _close(tnet.output(x), ml.network_output(tconf, tnet.params,
                                             torch.from_numpy(x)), 0)


@pytest.mark.parametrize("which", ["", "adam"])
@pytest.mark.parametrize("fused", [False, True])
def test_ema_leaves_come_out_of_the_updater_unchanged(which, fused):
    """The EMA leaves get zero gradients, so SGD with momentum and Adam,
    per leaf and on flat buffers, leave them exactly as they were (the
    0-d ema_w included)."""
    jconf, tconf = _vgg(width=4)
    tconf = tconf.replace(confs=tuple(
        c.replace(updater=which, fused_updater=fused, num_iterations=3)
        for c in tconf.confs))
    params = params_from_numpy(_np_params(jconf, seed=5, ema=True), "cpu")
    spec = updater.make_flat_spec(params)
    back = updater.flat_unravel(spec, updater.flat_ravel(spec, params))
    assert back[1]["ema_w"].shape == ()
    x, y = _cifar(4, seed=7)
    objective = solver.from_loss(lambda p: ml.network_loss(
        tconf, p, torch.from_numpy(x), torch.from_numpy(y)))
    new, _ = solver.optimize(objective, params, tconf.conf(10))
    for i in (1, 4, 7):
        for k in ("ema_mean", "ema_var", "ema_w"):
            assert new[i][k].shape == params[i][k].shape
            assert torch.equal(new[i][k], params[i][k]), (i, k)
        assert not torch.equal(new[i]["gamma"], params[i]["gamma"])


# --------------------------------------------------------------------- CLI

def _carry_jax_init(monkeypatch):
    """The port's `init` draws JAX's initial params for the same conf and
    seed (the generators differ), so a CLI run starts where JAX's does."""
    real_init = ml.MultiLayerNetwork.init

    def init(self):
        real_init(self)
        jconf = jax_conf.MultiLayerConfiguration.from_json(
            self.conf.to_json())
        jnet = jax_ml.MultiLayerNetwork(jconf, seed=self.seed).init()
        self.params = params_from_numpy(jax.device_get(jnet.params),
                                        self.device)
        return self

    monkeypatch.setattr(ml.MultiLayerNetwork, "init", init)


def _run(fn, argv, capsys):
    assert fn(argv) == 0
    return capsys.readouterr().out


def _last_json(out):
    import json

    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("zoo_spec,uri,want", [
    ("lenet5", "mnist:64", lambda: jax_zoo.lenet5(lr=0.05)),
    ("vgg_cifar10:width=8", "cifar10:32",
     lambda: jax_zoo.vgg_cifar10(lr=0.05, width=8))])
def test_cli_trains_conv_nets_and_predict_and_test_run(tmp_path, capsys,
                                                       monkeypatch, zoo_spec,
                                                       uri, want):
    """`train --zoo lenet5 --input mnist:64` and `--zoo vgg_cifar10:width=8
    --input cifar10:32` write JAX's zoo conf; from JAX's initial params the
    score is JAX CLI's within rtol 1e-4, and `predict` and `test` answer
    as the JAX CLI does on the same checkpoint."""
    monkeypatch.delenv("MNIST_DIR", raising=False)
    monkeypatch.delenv("DL4J_MNIST_URL", raising=False)
    monkeypatch.delenv("CIFAR10_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    _carry_jax_init(monkeypatch)
    common = ["train", "--input", uri, "--zoo", zoo_spec]
    j = _last_json(_run(jax_main, common + ["--output", str(tmp_path / "j")],
                        capsys))
    t = _last_json(_run(main, common + ["--output", str(tmp_path / "t"),
                                        "--device", "cpu"], capsys))
    np.testing.assert_allclose(t["score"], j["score"], rtol=1e-4)
    got = open(tmp_path / "t" / "conf.json").read()
    assert MultiLayerConfiguration.from_json(got).to_json() == \
        want().to_json()
    assert got == open(tmp_path / "j" / "conf.json").read()
    test = ["test", "--input", uri, "--batch", "0"]
    jt = _last_json(_run(jax_main, test + ["--model", str(tmp_path / "j")],
                         capsys))
    tt = _last_json(_run(main, test + ["--model", str(tmp_path / "t"),
                                       "--device", "cpu"], capsys))
    assert tt["accuracy"] == jt["accuracy"]
    preds = []
    for fn, model, extra in ((jax_main, "j", []), (main, "t", ["--device",
                                                              "cpu"])):
        out = str(tmp_path / f"{model}.csv")
        _run(fn, ["predict", "--input", uri, "--model", str(tmp_path / model),
                  "--output", out] + extra, capsys)
        rows = open(out).read().strip().splitlines()
        assert rows[0].startswith("prediction,")
        preds.append([r.split(",")[0] for r in rows[1:]])
    assert len(preds[1]) == int(uri.split(":")[1])
    assert preds[1] == preds[0]


# -------------------------------------------------------------------- card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")


def _copy_params(params, device):
    return tuple({k: v.detach().to(device).clone() for k, v in layer.items()}
                 for layer in params)


def _leaves_gap(got, want, ema):
    """max |got - want| / max |want| over the EMA leaves (ema=True) or
    the others."""
    pairs = [(a[k].float().cpu(), b[k].float().cpu())
             for a, b in zip(got, want) for k in sorted(b)
             if k.startswith("ema_") == ema]
    return (max(float((a - b).abs().max()) for a, b in pairs)
            / max(float(b.abs().max()) for _, b in pairs))


@pytest.mark.cuda
@pytest.mark.parametrize("net_name", ["lenet5", "vgg"])
def test_cuda_captured_and_eager_conv_steps_agree(net_name):
    """bf16 compute: each captured step's params agree with an eager
    step's within 2e-2 * max|param|. LeNet's two paths run two steps side
    by side; the VGG net's eager net takes the captured one's params
    before each step, since a BatchNorm trajectory amplifies each step's
    rounding (1 / sqrt(var + eps) of a near-dead channel). f32: the VGG
    net's captured and eager steps on the card each equal the CPU port's
    from the same params within 1e-4 * max|leaf|, EMA included (the two
    paths' EMA differ by JAX's design: the eager one comes from a forward
    after the step). `output` after a step reads the new params and EMA
    with no new capture."""
    _cuda_or_skip()
    jconf = (jax_zoo.lenet5() if net_name == "lenet5"
             else jax_zoo.vgg_cifar10(width=8))
    tconf = MultiLayerConfiguration.from_json(
        jconf.with_compute_dtype("bfloat16").to_json())
    x, y = _digits(64) if net_name == "lenet5" else _cifar(64)
    xd, yd = (torch.as_tensor(a, device="cuda") for a in (x, y))
    batches = [(xd[:32], yd[:32]), (xd[32:], yd[32:])]
    net = ml.MultiLayerNetwork(tconf, device="cuda", seed=0).init()
    ref = ml.MultiLayerNetwork(tconf, device="cuda", seed=0)
    ref.params = _copy_params(net.params, "cuda")
    ref.use_step_cache = ref.use_infer_cache = False
    for xb, yb in batches:
        if net_name == "vgg":
            ref.params = _copy_params(net.params, "cuda")
        net.fit(xb, yb)
        ref.fit(xb, yb)
        assert _leaves_gap(net.params, ref.params, ema=False) <= 2e-2
    assert net.step_cache.stats.misses == 1
    if net_name == "vgg":
        f32 = MultiLayerConfiguration.from_json(jconf.to_json())
        nets = {(dev, path): ml.MultiLayerNetwork(f32, device=dev,
                                                  seed=0).init()
                for dev in ("cuda", "cpu") for path in ("captured", "eager")}
        for (dev, path), n in nets.items():
            n.use_step_cache = path == "captured"
        lead = nets["cuda", "captured"]
        for xb, yb in batches:
            for (dev, path), n in nets.items():
                if n is not lead:
                    n.params = _copy_params(lead.params, dev)
            for (dev, path), n in nets.items():
                n.fit(xb.to(dev), yb.to(dev))
            for path in ("captured", "eager"):
                for ema in (False, True):
                    assert _leaves_gap(nets["cuda", path].params,
                                       nets["cpu", path].params,
                                       ema) <= 1e-4, (path, ema)
    out0 = net.output(xd[:32])
    misses = net.infer_cache.stats.misses
    net.fit(*batches[0])
    out1 = net.output(xd[:32])
    assert net.infer_cache.stats.misses == misses
    with torch.inference_mode():
        want_out = ml.network_output(tconf, net.params, xd[:32])
    assert float((out1 - want_out).abs().max()) <= 1e-5
    assert not torch.equal(out0, out1)

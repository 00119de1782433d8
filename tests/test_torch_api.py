"""Public API of ported modules vs the JAX package's (on the CPU).

`ListBuilder` confs give the JAX builder's `to_json` (the JAX tests'
confs); `register_activation` / `activation_derivative` give JAX's values
within 1e-6; a `register_layer`ed layer is what `feed_forward` runs (1e-5
against JAX's on carried-over params); `params_flat` is JAX's
`ravel_pytree` vector bitwise (order and promoted dtype), `set_params_flat`
writes in place and `clone` copies; `save_async` / `join_async` snapshot
at the call and raise a failed write again; `CheckpointListener` saves
every N iterations as JAX's does (scores within 1e-4), and
`ComposableIterationListener` fans out.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from deeplearning4j_tpu.nd import ops as jax_ops  # noqa: E402
from deeplearning4j_tpu.nn import conf as jc  # noqa: E402
from deeplearning4j_tpu.nn import layers as jax_layers  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.optimize import listeners as jax_listeners  # noqa: E402,E501
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.nd import ops  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as tc  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as port_layers  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.optimize import listeners  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


# -- ListBuilder -------------------------------------------------------------------

def _builder_cases(m):
    """The JAX tests' list_builder confs, built with package `m`'s conf
    module (tests/test_conf.py, tests/test_multilayer.py)."""
    lf = m.LossFunction
    algo = m.OptimizationAlgorithm
    cases = {}
    base = m.NeuralNetConfiguration(n_in=4, n_out=3)
    cases["json_roundtrip"] = (
        m.list_builder(base, 3).hidden_layer_sizes([8, 6], n_in=4, n_out=3)
        .override(2, layer_type=m.LayerType.OUTPUT,
                  loss_function=lf.MCXENT)
        .pretrain(False).backprop(True).build())
    base = m.NeuralNetConfiguration(
        activation="tanh", weight_init="vi", lr=0.1,
        optimization_algo=algo.CONJUGATE_GRADIENT, num_iterations=60,
        use_adagrad=True, seed=42)
    cases["iris_mlp"] = (
        m.list_builder(base, 2).hidden_layer_sizes([10], n_in=4, n_out=3)
        .override(1, layer_type=m.LayerType.OUTPUT,
                  loss_function=lf.MCXENT).build())
    base = m.NeuralNetConfiguration(
        layer_type=m.LayerType.RBM, activation="sigmoid", lr=0.05,
        optimization_algo=algo.ITERATION_GRADIENT_DESCENT,
        num_iterations=30, k=1, seed=7)
    cases["dbn"] = (
        m.list_builder(base, 3).hidden_layer_sizes([12, 8], n_in=4, n_out=3)
        .override(2, layer_type=m.LayerType.OUTPUT, loss_function=lf.MCXENT,
                  lr=0.1, optimization_algo=algo.CONJUGATE_GRADIENT,
                  num_iterations=60)
        .pretrain(True).backprop(True).build())
    base = m.NeuralNetConfiguration(
        activation="relu", lr=0.02, use_adagrad=True, momentum=0.0,
        optimization_algo=algo.ITERATION_GRADIENT_DESCENT,
        num_iterations=40, seed=3)
    pool = m.PoolingType.MAX
    cases["lenet"] = (
        m.list_builder(base, 6)
        .override(0, layer_type=m.LayerType.CONVOLUTION, n_channels=1,
                  n_out=6, kernel_size=(5, 5))
        .override(1, layer_type=m.LayerType.SUBSAMPLING, kernel_size=(2, 2),
                  stride=(2, 2), pooling=pool)
        .override(2, layer_type=m.LayerType.CONVOLUTION, n_channels=6,
                  n_out=16, kernel_size=(5, 5))
        .override(3, layer_type=m.LayerType.SUBSAMPLING, kernel_size=(2, 2),
                  stride=(2, 2), pooling=pool)
        .override(4, layer_type=m.LayerType.DENSE, n_in=16 * 4 * 4, n_out=84,
                  activation="tanh")
        .override(5, layer_type=m.LayerType.OUTPUT, n_in=84, n_out=10,
                  loss_function=lf.MCXENT)
        .input_preprocessor(0, "ff_to_conv:1:28:28")
        .input_preprocessor(4, "conv_to_ff").build())
    return cases


class _ConfModule:
    """A package's conf names in one namespace."""

    def __init__(self, conf_mod, losses_mod):
        self.__dict__.update({k: getattr(conf_mod, k) for k in (
            "NeuralNetConfiguration", "LayerType", "OptimizationAlgorithm",
            "PoolingType", "list_builder", "MultiLayerConfiguration")})
        self.LossFunction = losses_mod.LossFunction


def _modules():
    from deeplearning4j_tpu.nd import losses as jax_losses
    from deeplearning4j_tpu_torch.nd import losses as port_losses

    return _ConfModule(jc, jax_losses), _ConfModule(tc, port_losses)


@pytest.mark.parametrize("case", ["json_roundtrip", "iris_mlp", "dbn",
                                  "lenet"])
def test_list_builder_confs_give_jaxs_json(case):
    jm, tm = _modules()
    want = _builder_cases(jm)[case]
    got = _builder_cases(tm)[case]
    assert got.to_json() == want.to_json()
    assert tc.MultiLayerConfiguration.from_json(got.to_json()) == got
    assert isinstance(tc.list_builder(got.conf(0), 2), tc.ListBuilder)


# -- activations -------------------------------------------------------------------

#: values on both sides of every kink, and the kinks themselves (0, +-1)
X = np.concatenate([
    np.linspace(-3.1, 2.9, 41, dtype=np.float32).reshape(41, 1) *
    np.asarray([[1.0, -0.5, 0.25]], np.float32),
    np.asarray([[0.0, 1.0, -1.0]], np.float32)])


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "relu", "leakyrelu",
                                  "softmax", "softplus", "linear",
                                  "identity", "hardtanh", "exp", "elu",
                                  "gelu"])
def test_activation_derivative_equals_jax(name):
    got = ops.activation_derivative(name, torch.from_numpy(X)).numpy()
    want = np.asarray(jax_ops.activation_derivative(name, jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with torch.inference_mode():
        again = ops.activation_derivative(name, torch.from_numpy(X))
    np.testing.assert_array_equal(again.numpy(), got)


def test_registered_activation_is_used_by_layers_and_differentiated():
    jax_ops.register_activation("softsign2", lambda x: 2 * x / (1 + abs(x)))
    ops.register_activation("softsign2",
                            lambda x: 2 * x / (1 + torch.abs(x)))
    try:
        x = torch.from_numpy(X)
        np.testing.assert_allclose(
            ops.activate("SoftSign2", x).numpy(),
            np.asarray(jax_ops.activate("softsign2", jnp.asarray(X))),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            ops.activation_derivative("softsign2", x).numpy(),
            np.asarray(jax_ops.activation_derivative("softsign2",
                                                     jnp.asarray(X))),
            rtol=1e-6, atol=1e-6)
        # a dense layer of that activation, on JAX's params
        # (a conf JSON names only the Activation enum's members, in both
        # packages: the confs are built directly)
        jconf = jc.MultiLayerConfiguration(confs=(
            jc.NeuralNetConfiguration(layer_type=jc.LayerType.DENSE, n_in=3,
                                      n_out=5, activation="softsign2"),))
        jparams = jax_ml.init_params(jconf, jax.random.PRNGKey(1))
        tconf = tc.MultiLayerConfiguration(confs=(
            tc.NeuralNetConfiguration(layer_type=tc.LayerType.DENSE, n_in=3,
                                      n_out=5, activation="softsign2"),))
        got = ml.network_output(
            tconf, checkpoint.params_from_numpy(
                jax.device_get(jparams), "cpu"), x)
        want = jax_ml.network_output(jconf, jparams, jnp.asarray(X))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    finally:
        del jax_ops._REGISTRY["softsign2"], ops._REGISTRY["softsign2"]
    with pytest.raises(KeyError, match="unknown activation"):
        ops.get_activation("softsign2")


# -- layers ---------------------------------------------------------------------------

class _JaxScaledTanh:
    """A layer type of the caller's own: 2 tanh(x W + b)."""

    @staticmethod
    def init(key, conf):
        return {"W": 0.3 * jax.random.normal(key, (conf.n_in, conf.n_out)),
                "b": jnp.full((conf.n_out,), 0.1)}

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        return 2 * jnp.tanh(x @ params["W"] + params["b"])


class _PortScaledTanh:
    @staticmethod
    def init(key, conf):
        return {"W": 0.3 * nd_random.normal(key, 0.0, 1.0,
                                            (conf.n_in, conf.n_out)),
                "b": torch.full((conf.n_out,), 0.1, device=key.device)}

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        return 2 * torch.tanh(x @ params["W"] + params["b"])


def test_registered_layer_is_run_by_feed_forward():
    """A layer registered for a type (here RBM's, which is ported: it
    raised naming item 9 before) replaces the type's implementation, and
    `feed_forward` runs it (JAX's registration of the same layer on the
    same params agrees to 1e-5); restoring the registry restores RBM."""
    from deeplearning4j_tpu_torch.nn.layers.rbm import RBM

    assert port_layers.get_layer("rbm") is RBM
    j_old = jax_layers._REGISTRY[jc.LayerType.RBM]
    jax_layers.register_layer("rbm", _JaxScaledTanh)
    port_layers.register_layer(tc.LayerType.RBM, _PortScaledTanh)
    try:
        jconf = jc.MultiLayerConfiguration(confs=(
            jc.NeuralNetConfiguration(layer_type=jc.LayerType.RBM, n_in=3,
                                      n_out=6),
            jc.NeuralNetConfiguration(layer_type=jc.LayerType.OUTPUT,
                                      n_in=6, n_out=4, activation="softmax",
                                      loss_function="mcxent")))
        tconf = tc.MultiLayerConfiguration.from_json(jconf.to_json())
        assert port_layers.get_layer("rbm") is _PortScaledTanh
        jparams = jax_ml.init_params(jconf, jax.random.PRNGKey(2))
        tparams = checkpoint.params_from_numpy(jax.device_get(jparams),
                                               "cpu")
        got = ml.feed_forward(tconf, tparams, torch.from_numpy(X))
        want = jax_ml.feed_forward(jconf, jparams, jnp.asarray(X))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        net = ml.MultiLayerNetwork(tconf, device="cpu", seed=0).init()
        assert set(net.params[0]) == {"W", "b"}
    finally:
        jax_layers._REGISTRY[jc.LayerType.RBM] = j_old
        port_layers.register_layer(tc.LayerType.RBM, RBM)
    assert port_layers.get_layer("rbm") is RBM


# -- the flat parameter vector and clone -----------------------------------------------

def _iris_conf(m, algo="ITERATION_GRADIENT_DESCENT", iters=4):
    jm, tm = _modules()
    mod = jm if m == "jax" else tm
    base = mod.NeuralNetConfiguration(
        activation="tanh", weight_init="vi", lr=0.1,
        optimization_algo=getattr(mod.OptimizationAlgorithm, algo),
        num_iterations=iters, seed=42)
    return (mod.list_builder(base, 3).hidden_layer_sizes([10, 7], n_in=4,
                                                          n_out=3)
            .override(2, layer_type=mod.LayerType.OUTPUT,
                      loss_function=mod.LossFunction.MCXENT).build())


def _pair_nets(iters=4):
    """A JAX net and the port's net on its params (CPU)."""
    jnet = jax_ml.MultiLayerNetwork(_iris_conf("jax", iters=iters)).init()
    tnet = ml.MultiLayerNetwork(_iris_conf("port", iters=iters),
                                device="cpu")
    tnet.params = checkpoint.params_from_numpy(jax.device_get(jnet.params),
                                               "cpu")
    return jnet, tnet


def _iris():
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher

    d = IrisDataFetcher().fetch(150).normalize_zero_mean_unit_variance()
    return d.features.astype(np.float32), d.labels


@pytest.mark.parametrize("mixed", [False, True])
def test_params_flat_is_jaxs_ravel_pytree(mixed):
    jnet, tnet = _pair_nets()
    if mixed:
        # one bf16 leaf: both promote the vector to float32
        jnet.params = tuple(
            {k: (v.astype(jnp.bfloat16) if (i, k) == (1, "W") else v)
             for k, v in layer.items()} for i, layer in enumerate(
                jnet.params))
        tnet.params = checkpoint.params_from_numpy(
            jax.device_get(jnet.params), "cpu")
        assert tnet.params[1]["W"].dtype == torch.bfloat16
    want = np.asarray(ravel_pytree(jnet.params)[0])
    got = tnet.params_flat()
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnet.params_flat()))


def test_set_params_flat_writes_in_place_as_jax_unravels():
    jnet, tnet = _pair_nets()
    ptrs = [t.data_ptr() for t in tree_leaves(tnet.params)]
    leaves = tree_leaves(tnet.params)
    flat = np.random.RandomState(3).standard_normal(
        sum(t.numel() for t in leaves)).astype(np.float32)
    tnet.set_params_flat(flat)
    jnet.set_params_flat(flat)
    assert [t.data_ptr() for t in tree_leaves(tnet.params)] == ptrs
    for t, j in zip(tree_leaves(tnet.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tnet.params_flat().numpy(), flat)
    with pytest.raises(ValueError, match="elements"):
        tnet.set_params_flat(flat[:-1])


def test_set_params_flat_keeps_the_step_caches_program():
    """The captured step reads params by address: after a round trip the
    next step is a hit of the same program, not a new one."""
    _, tnet = _pair_nets(iters=1)
    x, y = _iris()
    tnet.fit(x, y)
    books = dict(tnet.step_cache.stats.as_dict())
    tnet.set_params_flat(tnet.params_flat() * 0.5)
    tnet.fit(x, y)
    after = tnet.step_cache.stats.as_dict()
    assert after["misses"] == books["misses"] == 1
    assert after["hits"] == books["hits"] + 1


def test_clone_copies_and_trains_apart():
    jnet, tnet = _pair_nets()
    x, y = _iris()
    twin = tnet.clone()
    assert twin.conf == tnet.conf and twin.device == tnet.device
    for a, b in zip(tree_leaves(twin.params), tree_leaves(tnet.params)):
        assert a.data_ptr() != b.data_ptr()
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    before = tnet.params_flat().clone()
    twin.fit(x, y)
    np.testing.assert_array_equal(tnet.params_flat().numpy(),
                                  before.numpy())
    assert not torch.equal(twin.params_flat(), before)
    # and the clone trains as JAX's clone does (the same first params)
    jtwin = jnet.clone()
    jtwin.fit(x, y)
    np.testing.assert_allclose(twin.params_flat().numpy(),
                               np.asarray(jtwin.params_flat()), rtol=1e-4,
                               atol=1e-5)


# -- asynchronous checkpoints and listeners ---------------------------------------------

def test_save_async_snapshots_at_the_call_and_jax_reads_it(tmp_path):
    jnet, tnet = _pair_nets()
    want = [t.clone() for t in tree_leaves(tnet.params)]
    faults.arm("checkpoint.save", "delay", delay_s=0.2)
    t = checkpoint.save_async(str(tmp_path / "a"), tnet.params,
                              conf=tnet.conf, step=3)
    with torch.no_grad():  # the next step overwrites the params at once
        for leaf in tree_leaves(tnet.params):
            leaf.add_(1.0)
    checkpoint.join_async()
    assert not t.is_alive()
    params, _, meta = jax_checkpoint.load(str(tmp_path / "a"),
                                          like_params=jnet.params)
    assert meta["step"] == 3
    for w, j in zip(want, jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(w.numpy(), np.asarray(j))


def test_failed_async_save_is_raised_at_the_next_call(tmp_path):
    _, tnet = _pair_nets()
    faults.arm("checkpoint.save", "raise", times=1)
    checkpoint.save_async(str(tmp_path / "a"), tnet.params)
    with pytest.raises(faults.FaultInjected):
        checkpoint.join_async()
    checkpoint.join_async()  # raised once, then cleared
    faults.arm("checkpoint.save", "raise", times=1)
    checkpoint.save_async(str(tmp_path / "b"), tnet.params).join()
    with pytest.raises(faults.FaultInjected):
        checkpoint.save_async(str(tmp_path / "c"), tnet.params)
    checkpoint.save_async(str(tmp_path / "c"), tnet.params)
    checkpoint.join_async()
    assert (tmp_path / "c" / "arrays.npz").exists()
    assert not (tmp_path / "b").exists()


class _Record(listeners.IterationListener):
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration, score):
        self.seen.append((iteration, score))


class _JaxRecord(jax_listeners.IterationListener):
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration, score):
        self.seen.append((iteration, score))


@pytest.mark.parametrize("asynchronous", [True, False])
def test_checkpoint_listener_saves_every_n_as_jax(tmp_path, asynchronous):
    jnet, tnet = _pair_nets(iters=5)
    x, y = _iris()
    got = listeners.CheckpointListener(str(tmp_path / "port"),
                                       save_every_n=2,
                                       asynchronous=asynchronous)
    # the JAX listener saves synchronously in both cases: its asynchronous
    # saves into one directory write at once and can race on '<dir>.bak'
    # (ROADMAP.md, reference faults); the port's land in call order
    want = jax_listeners.CheckpointListener(str(tmp_path / "jax"),
                                            save_every_n=2,
                                            asynchronous=False)
    rec, jrec = _Record(), _JaxRecord()
    tnet.set_listeners([listeners.ComposableIterationListener([got, rec])])
    jnet.set_listeners([jax_listeners.ComposableIterationListener(
        [want, jrec])])
    for _ in range(2):
        tnet.fit(x, y)
        jnet.fit(x, y)
    got.wait()
    want.wait()
    assert got.saves == want.saves == 6  # iterations 0, 2, 4 of two runs
    assert [i for i, _ in rec.seen] == [i for i, _ in jrec.seen]
    np.testing.assert_allclose([s for _, s in rec.seen],
                               [s for _, s in jrec.seen], rtol=1e-4)
    tparams, _, tmeta = checkpoint.load(str(tmp_path / "port"),
                                        like_params=tnet.params)
    _, _, jmeta = jax_checkpoint.load(str(tmp_path / "jax"))
    assert tmeta["step"] == jmeta["step"] == 4
    np.testing.assert_allclose(tmeta["metadata"]["score"],
                               jmeta["metadata"]["score"], rtol=1e-4)
    # the last save holds the params as the run left them
    for a, b in zip(tree_leaves(tparams), tree_leaves(tnet.params)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    conf = tc.MultiLayerConfiguration.from_json(
        open(tmp_path / "port" / "conf.json").read())
    assert conf == tnet.conf


def test_async_saves_into_one_directory_land_in_call_order(tmp_path):
    """Saves of a burst into one directory are written one after another,
    in the order of the calls, so the directory ends with the last
    snapshot (the JAX package's writers run at once and can race on
    '<dir>.bak': ROADMAP.md, reference faults)."""
    _, tnet = _pair_nets()
    d = str(tmp_path / "ck")
    for k in range(6):
        with torch.no_grad():
            tree_leaves(tnet.params)[0].fill_(float(k))
        checkpoint.save_async(d, tnet.params, step=k)
    checkpoint.join_async()
    params, _, meta = checkpoint.load(d, like_params=tnet.params)
    assert meta["step"] == 5
    assert bool((tree_leaves(params)[0] == 5.0).all())
    assert not (tmp_path / "ck.bak").exists()

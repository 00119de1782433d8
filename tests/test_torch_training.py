"""Training in the port vs the JAX package.

The losses, the updater chain (tree and flat layouts), the solver, the
listeners, the network's loss and gradients, `fit`, and checkpoints that
the port writes and the JAX package reads. Inputs and weights are drawn
from numpy seeds and cross as numpy arrays; the JAX package's flash kernel
runs in interpret mode. Tolerances: losses and updaters 1e-6 (the same
elementwise f32 math); the network's f32 loss 1e-5 and gradients 1e-4,
bf16 compute 2e-2 * max|g|; `fit` trajectories 1e-5 (scores at the zoo's
lr 1e-3, where they rise, 1e-4).
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nd import losses as jax_losses  # noqa: E402
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.optimize import listeners as jax_listeners  # noqa: E402,E501
from deeplearning4j_tpu.optimize import solver as jax_solver  # noqa: E402
from deeplearning4j_tpu.optimize import updater as jax_updater  # noqa: E402
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.nd import losses  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.optimize import listeners, solver, updater  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402

VOCAB, ROWS, SEQ = 24, 2, 8


def _np_tree(tree):
    return [{k: np.asarray(v, np.float32) for k, v in layer.items()}
            for layer in tree]


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------------------ losses

def _loss_inputs(seed, sparse, rows=6, classes=5):
    rng = np.random.RandomState(seed)
    z = rng.standard_normal((rows, classes))
    out = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    labels = (rng.randint(0, classes, rows).astype(np.int32) if sparse
              else rng.uniform(0.0, 1.0, (rows, classes)).astype(np.float32))
    return labels, out


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("name", [lf.value for lf in losses.LossFunction])
def test_loss_forms_match_jax(name, sparse):
    labels, out = _loss_inputs(0, sparse)
    tl, to = torch.from_numpy(labels), torch.from_numpy(out)
    jl, jo = jnp.asarray(labels), jnp.asarray(out)
    if sparse and name not in ("mcxent", "negativeloglikelihood"):
        with pytest.raises(TypeError, match="sparse"):
            jax_losses.get_rowwise(name)(jl, jo)
        with pytest.raises(TypeError, match="sparse"):
            losses.get_rowwise(name)(tl, to)
        with pytest.raises(TypeError, match="sparse"):
            losses.get_loss(name)(tl, to)
        return
    _close(losses.get_rowwise(name)(tl, to),
           jax_losses.get_rowwise(name)(jl, jo), 1e-6)
    _close(losses.get_loss(name)(tl, to), jax_losses.get_loss(name)(jl, jo),
           1e-6)
    w2 = float(np.sum(out ** 2))
    _close(losses.score(tl, name, to, 0.1, torch.tensor(w2)),
           jax_losses.score(jl, name, jo, 0.1, jnp.asarray(w2)), 1e-6)


def test_sparse_mcxent_equals_the_one_hot_form():
    labels, out = _loss_inputs(1, sparse=True)
    one_hot = np.eye(5, dtype=np.float32)[labels]
    got = losses.mcxent_sparse_rows(torch.from_numpy(labels),
                                    torch.from_numpy(out))
    want = losses.mcxent_rows(torch.from_numpy(one_hot),
                              torch.from_numpy(out))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_losses_reduce_in_f32_over_bf16_outputs():
    labels, out = _loss_inputs(2, sparse=True)
    to = torch.from_numpy(out).to(torch.bfloat16)
    got = losses.get_loss("mcxent")(torch.from_numpy(labels), to)
    assert got.dtype == torch.float32
    want = jax_losses.get_loss("mcxent")(jnp.asarray(labels),
                                         jnp.asarray(out, jnp.bfloat16))
    _close(got, want, 1e-6)


# ----------------------------------------------------------------- updater

def _updater_kwargs(which, extra):
    kw = dict(lr=0.05, updater=which, momentum=0.5,
              momentum_after=((2, 0.9),), use_adagrad=True,
              adagrad_reset_iterations=3)
    if extra == "l2":
        kw.update(use_regularization=True, l2=1e-2)
    elif extra == "clip":
        kw["gradient_clip_norm"] = 0.05
    else:
        kw["constrain_gradient_to_unit_norm"] = True
    return kw


def _updater_trees(seed):
    """params, grads, squared-gradient history, velocity: two layers."""
    rng = np.random.RandomState(seed)

    def tree(scale=1.0, positive=False):
        out = []
        for shape in (((3, 4), (4,)), ((4, 2), (2,))):
            d = {}
            for name, s in zip(("W", "b"), shape):
                x = scale * rng.standard_normal(s).astype(np.float32)
                d[name] = np.abs(x) if positive else x
            out.append(d)
        return tuple(out)

    return tree(), tree(), tree(0.5, positive=True), tree(0.3)


def _to_torch(tree):
    return tuple({k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
                 for layer in tree)


def _to_jax(tree):
    return tuple({k: jnp.asarray(v) for k, v in layer.items()}
                 for layer in tree)


def _port_adjust(conf, it, params, grads, hist, vel, flat):
    p, g, h, v = (_to_torch(t) for t in (params, grads, hist, vel))
    if not flat:
        step, st = updater.adjust_gradient(conf, it, g, p,
                                           updater.UpdaterState(h, v))
        return step, st.adagrad_hist, st.velocity
    spec = updater.make_flat_spec(p)
    rav = (lambda t: updater.flat_ravel(spec, t))
    step, st = updater.adjust_gradient_flat(
        conf, it, rav(g), rav(p), updater.UpdaterState(rav(h), rav(v)), spec)
    return tuple(updater.flat_unravel(spec, t)
                 for t in (step, st.adagrad_hist, st.velocity))


def _jax_adjust(conf, it, params, grads, hist, vel, flat):
    p, g, h, v = (_to_jax(t) for t in (params, grads, hist, vel))
    if not flat:
        step, st = jax_updater.adjust_gradient(
            conf, it, g, p, jax_updater.UpdaterState(h, v))
        return step, st.adagrad_hist, st.velocity
    spec = jax_updater.make_flat_spec(p)
    rav = (lambda t: jax_updater.flat_ravel(spec, t))
    step, st = jax_updater.adjust_gradient_flat(
        conf, it, rav(g), rav(p),
        jax_updater.UpdaterState(rav(h), rav(v)), spec)
    return tuple(jax_updater.flat_unravel(spec, t)
                 for t in (step, st.adagrad_hist, st.velocity))


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("extra", ["l2", "clip", "unit_norm"])
@pytest.mark.parametrize("which", ["", "sgd", "adagrad", "nesterov", "adam",
                                   "rmsprop"])
def test_adjust_gradient_matches_jax(which, extra, flat):
    kw = _updater_kwargs(which, extra)
    tconf = NeuralNetConfiguration(**kw)
    jconf = jax_conf.NeuralNetConfiguration(**kw)
    trees = _updater_trees(3)
    # iterations 0 and 3 reset AdaGrad's history; 2 and 3 take the
    # scheduled momentum
    for it in (0, 1, 2, 3):
        got = _port_adjust(tconf, it, *trees, flat)
        want = _jax_adjust(jconf, it, *trees, flat)
        for g, w in zip(got, want):
            for gl, wl in zip(tree_leaves(g),
                              jax.tree_util.tree_leaves(w)):
                _close(gl, wl, 1e-6)


@pytest.mark.parametrize("which", ["", "nesterov", "adam", "rmsprop"])
def test_flat_and_tree_updaters_agree(which):
    conf = NeuralNetConfiguration(**_updater_kwargs(which, "clip"))
    trees = _updater_trees(4)
    for it in (0, 3):
        tree = _port_adjust(conf, it, *trees, flat=False)
        flat = _port_adjust(conf, it, *trees, flat=True)
        for a, b in zip(tree, flat):
            for x, y in zip(tree_leaves(a), tree_leaves(b)):
                _close(x, y.numpy(), 1e-7)


def test_unknown_updater_raises():
    conf = NeuralNetConfiguration(updater="lamb")
    trees = _updater_trees(5)
    with pytest.raises(ValueError, match="unknown updater"):
        _port_adjust(conf, 0, *trees, flat=False)


# ------------------------------------------------------------------ solver

def _quadratic(lib, target):
    """0.5 * |w - target|^2 summed, over a one-layer params tree."""
    def loss(params, *key):
        d = params[0]["w"] - target
        return 0.5 * lib.sum(d * d)

    return loss


@pytest.mark.parametrize("form", ["eager", "device"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("stop", ["norm2", "eps", "none", "zero_direction"])
def test_sgd_solver_matches_jax(stop, fused, form):
    # "norm2" trips on a large gradient-norm floor, "eps" stalls on a tiny
    # learning rate (STALL_PATIENCE iterations), "none" runs every
    # iteration; once done, params freeze and the score repeats. "device"
    # is the graph-safe form the step cache captures: termination carried
    # on the device, updates masked
    kw = dict(optimization_algo="iteration_gradient_descent", lr=0.2,
              updater="sgd", momentum=0.0, num_iterations=12,
              fused_updater=fused,
              termination_conditions={"norm2": ("norm2",), "eps": ("eps",),
                                      "none": (),
                                      "zero_direction": ("zero_direction",)
                                      }[stop])
    if stop == "norm2":
        kw["termination_norm2"] = 1.0
    if stop == "eps":
        kw.update(lr=1e-4, termination_eps=1e-2)
    if stop == "zero_direction":
        kw["lr"] = 0.0
    target = np.linspace(-2.0, 2.0, 6).astype(np.float32)
    w0 = np.zeros(6, np.float32)
    jp, js = jax_solver.optimize(
        jax_solver.from_loss(_quadratic(jnp, jnp.asarray(target))),
        ({"w": jnp.asarray(w0)},), jax_conf.NeuralNetConfiguration(**kw),
        jax.random.PRNGKey(0))
    run = solver.optimize_with_aux if form == "eager" else solver.sgd_device
    tp, ts, aux = run(
        solver.from_loss(_quadratic(torch, torch.from_numpy(target))),
        ({"w": torch.from_numpy(w0.copy())},), NeuralNetConfiguration(**kw))
    assert aux == ()
    if form == "device":
        assert ts.dtype == torch.float32
        ts = ts.numpy()
    assert ts.dtype == np.float32 and ts.shape == (12,)
    _close(ts, np.asarray(js), 1e-6)
    _close(tp[0]["w"], jp[0]["w"], 1e-6)
    if stop != "none":
        assert ts[-1] == ts[-2]


@pytest.mark.parametrize("sf", ["default", "gradient", "negative_gradient",
                                "negative_default"])
def test_step_functions_match_jax(sf):
    conf = NeuralNetConfiguration(step_function=sf)
    x, d = np.arange(4, dtype=np.float32), np.full(4, 0.5, np.float32)
    _close(solver.apply_step(conf, torch.from_numpy(x), torch.from_numpy(d),
                             0.3),
           jax_solver.apply_step(conf, jnp.asarray(x), jnp.asarray(d), 0.3),
           1e-7)


def test_termination_predicate_matches_jax():
    conf = NeuralNetConfiguration(
        termination_conditions=("eps", "norm2", "zero_direction"))
    got, want = solver.make_termination(conf), jax_solver.make_termination(
        conf)
    for args in ((1.0, 1.0 + 1e-7, 1.0, 1.0), (1.0, 2.0, 1e-9, 1.0),
                 (1.0, 2.0, 1.0, 1e-13), (1.0, 2.0, 1.0, 1.0)):
        assert got(*args) == tuple(bool(b) for b in want(*args))


@pytest.mark.parametrize("algo", ["conjugate_gradient", "lbfgs",
                                  "gradient_descent", "hessian_free"])
def test_other_solvers_run_as_jax(algo):
    """Each raised naming item 9 before; now each runs the quadratic as
    JAX's does (tests/test_torch_solvers.py holds them further)."""
    conf = NeuralNetConfiguration(optimization_algo=algo, num_iterations=6,
                                  hf_cg_iterations=4)
    objective = solver.from_loss(_quadratic(torch, torch.zeros(2)))
    got_p, got_s = solver.optimize(objective, ({"w": torch.ones(2)},), conf)
    want_p, want_s = jax_solver.optimize(
        jax_solver.from_loss(_quadratic(jnp, jnp.zeros(2))),
        ({"w": jnp.ones(2)},), jax_conf.NeuralNetConfiguration(
            optimization_algo=algo, num_iterations=6, hf_cg_iterations=4),
        jax.random.PRNGKey(0))
    _close(got_s, want_s, 1e-5)
    _close(got_p[0]["w"], want_p[0]["w"], 1e-5)


# --------------------------------------------------------------- listeners

class _Record(jax_listeners.IterationListener):
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration, score):
        self.seen.append((iteration, score))


class _PortRecord(listeners.IterationListener):
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration, score):
        self.seen.append((iteration, score))


@pytest.mark.parametrize("scores", [[3.0, 2.0, 1.0], [3.0, 2.0, 2.0, 2.0],
                                    [np.nan, 2.0, 1.5], [1.0]])
def test_listener_dispatch_matches_jax(scores):
    got, want = _PortRecord(), _Record()
    listeners.dispatch([got], None, np.asarray(scores, np.float32))
    jax_listeners.dispatch([want], None, np.asarray(scores, np.float32))
    assert got.seen == want.seen


def test_score_iteration_listener_logs_every_n(caplog):
    import logging

    lst = listeners.ScoreIterationListener(print_iterations=2)
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        listeners.dispatch([lst], None, np.asarray([3.0, 2.0, 1.0, 0.5],
                                                   np.float32))
    assert [r.getMessage() for r in caplog.records] == [
        "Score at iteration 0 is 3.0", "Score at iteration 2 is 1.0"]


# ----------------------------------------------------------------- network

def _confs(compute_dtype="", fused_updater=False, iterations=1):
    """(JAX conf, port conf): the small flash charTransformer with the
    fused attention backward."""
    jconf = jax_zoo.char_transformer(
        VOCAB, d_model=16, n_blocks=2, n_heads=2, max_seq_len=16,
        iterations=iterations, sparse_labels=True,
        fused_updater=fused_updater, attention_fused_bwd=True)
    jconf = jconf.replace(confs=tuple(c.replace(attention_impl="flash")
                                      for c in jconf.confs))
    if compute_dtype:
        jconf = jconf.with_compute_dtype(compute_dtype)
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _numpy_params(jconf, seed=0):
    """JAX-shaped params drawn from a numpy seed (nonzero biases,
    perturbed layer-norm gains)."""
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


def _batch(seed, sparse=True):
    ids = np.random.RandomState(seed).randint(0, VOCAB, (ROWS, SEQ + 1))
    x = ids[:, :-1].astype(np.int32)
    y = ids[:, 1:].reshape(ROWS * SEQ).astype(np.int32)
    if not sparse:
        y = np.eye(VOCAB, dtype=np.float32)[y]
    return x, y


def _jax_params(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


@pytest.mark.parametrize("compute_dtype,sparse", [("", True), ("", False),
                                                  ("bfloat16", True)])
def test_network_loss_and_grads_match_jax(compute_dtype, sparse):
    jconf, tconf = _confs(compute_dtype)
    np_params = _numpy_params(jconf, seed=1)
    x, y = _batch(2, sparse)
    want_loss, want_g = jax.value_and_grad(
        lambda p: jax_ml.network_loss(jconf, p, jnp.asarray(x),
                                      jnp.asarray(y)))(_jax_params(np_params))
    got_g, got_loss = solver.from_loss(
        lambda p: ml.network_loss(tconf, p, torch.from_numpy(x),
                                  torch.from_numpy(y))).grad_and_score(
        checkpoint.params_from_numpy(np_params, "cpu"))
    want_leaves = jax.tree_util.tree_leaves(want_g)
    got_leaves = tree_leaves(got_g)
    assert len(got_leaves) == len(want_leaves)
    if not compute_dtype:
        _close(got_loss, want_loss, 1e-5)
        for g, w in zip(got_leaves, want_leaves):
            _close(g, w, 1e-4)
        return
    _close(got_loss, want_loss, 2e-2)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= 2e-2 * np.abs(w).max()


def test_rowwise_loss_regularization_and_finetune_loss_match_jax():
    jconf, tconf = _confs()
    jconf = jconf.replace(confs=tuple(c.replace(use_regularization=True,
                                                l2=1e-2, l1=1e-3)
                                      for c in jconf.confs))
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    np_params = _numpy_params(jconf, seed=3)
    jp, tp = (_jax_params(np_params),
              checkpoint.params_from_numpy(np_params, "cpu"))
    x, y = _batch(4)
    w = np.ones(ROWS * SEQ, np.float32)
    w[-3:] = 0.0
    tx, ty, tw = (torch.from_numpy(a) for a in (x, y, w))
    jx, jy, jw = (jnp.asarray(a) for a in (x, y, w))
    _close(ml.network_rowwise_loss(tconf, tp, tx, ty),
           jax_ml.network_rowwise_loss(jconf, jp, jx, jy), 1e-5)
    _close(ml.network_regularization(tconf, tp),
           jax_ml.network_regularization(jconf, jp), 1e-5)
    _close(ml.network_loss(tconf, tp, tx, ty),
           jax_ml.network_loss(jconf, jp, jx, jy), 1e-5)
    # (loss, BatchNorm stats), JAX's signature
    _close(ml.make_finetune_loss(tconf)(tp, tx, ty, tw, None)[0],
           jax_ml.make_finetune_loss(jconf)(jp, jx, jy, jw, None)[0], 1e-5)


class _JaxScores(jax_listeners.IterationListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(score)


class _PortScores(listeners.IterationListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(score)


@pytest.mark.parametrize("fused_updater", [False, True])
def test_fit_trajectory_matches_jax(fused_updater):
    # three batches, two Adam iterations each: the updater restarts from
    # zero moments on every batch in the JAX package, and must here too
    jconf, tconf = _confs(fused_updater=fused_updater, iterations=2)
    np_params = _numpy_params(jconf, seed=5)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0)
    jnet.params = _jax_params(np_params)
    jrec = _JaxScores()
    jnet.set_listeners([jrec])
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=0)
    tnet.params = checkpoint.params_from_numpy(np_params, "cpu")
    trec = _PortScores()
    tnet.set_listeners([trec])
    n = 16  # d_model
    for fit in range(3):
        x, y = _batch(6 + fit)
        jnet.fit(x, y)
        tnet.fit(x, y)
        for layer, (tp, jp) in enumerate(zip(tnet.params, jnet.params)):
            for name in tp:
                got, want = tp[name], np.asarray(jp[name])
                if name != "bqkv":
                    _close(got, want, 1e-5)
                    continue
                # The key bias adds one constant to every score of a query
                # row, which the softmax cancels: its gradient is f32
                # rounding noise in both packages, and Adam's first step
                # (lr * g / (|g| + eps)) turns noise into steps of up to
                # lr. It moves the loss not at all; q and v biases are held.
                _close(got[:n], want[:n], 1e-5)
                _close(got[2 * n:], want[2 * n:], 1e-5)
                drift = np.abs(got[n:2 * n].numpy() - want[n:2 * n]).max()
                assert drift <= 2 * 2 * (fit + 1) * tconf.conf(layer).lr
        _close(tnet.score(x, y), jnet.score(x, y), 1e-5)
    assert len(trec.scores) == len(jrec.scores) == 6
    _close(np.asarray(trec.scores), np.asarray(jrec.scores), 1e-5)


def test_fit_at_the_zoo_lr_rises_alike_in_both_packages():
    # `fit` restarts Adam from zero moments on every call, so each one-step
    # call moves every weight by about lr. At the zoo's lr 1e-3 and the
    # flagship's depth (8 blocks, d_model cut to 512) the score rises over
    # three calls in the JAX package, and the port follows it: the rise is
    # the algorithm, not the port. Scores at rtol 1e-4: Adam's first step
    # turns the key bias's f32 noise (see above) into steps of lr, which the
    # rising trajectory carries.
    vocab, seq, rows = 256, 64, 4
    jconf = jax_zoo.char_transformer(
        vocab, d_model=512, n_blocks=8, n_heads=4, max_seq_len=seq,
        sparse_labels=True, fused_updater=True, attention_fused_bwd=True)
    jconf = jconf.replace(confs=tuple(c.replace(attention_impl="flash")
                                      for c in jconf.confs))
    assert all(c.lr == 1e-3 for c in jconf.confs)
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    np_params = tuple(
        {k: np.asarray(v) for k, v in layer.items()}
        for layer in jax_ml.init_params(jconf, jax.random.PRNGKey(0)))
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0)
    jnet.params = _jax_params(np_params)
    tnet = ml.MultiLayerNetwork(tconf, device="cpu", seed=0)
    tnet.params = checkpoint.params_from_numpy(np_params, "cpu")
    ids = np.random.RandomState(0).randint(0, vocab, (rows, seq + 1))
    x = ids[:, :-1].astype(np.int32)
    y = ids[:, 1:].reshape(rows * seq).astype(np.int32)
    want, got = [float(jnet.score(x, y))], [tnet.score(x, y)]
    for _ in range(3):
        jnet.fit(x, y)
        tnet.fit(x, y)
        want.append(float(jnet.score(x, y)))
        got.append(tnet.score(x, y))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert all(a < b for a, b in zip(want, want[1:])), want


def test_fit_takes_datasets_lists_and_iterators():
    class DataSet:
        def __init__(self, features, labels):
            self.features, self.labels = features, labels

    _, tconf = _confs()
    np_params = _numpy_params(_confs()[0], seed=9)
    batches = [_batch(10), _batch(11)]
    nets = []
    for data in (batches, [DataSet(*b) for b in batches],
                 iter([DataSet(*b) for b in batches])):
        net = ml.MultiLayerNetwork(tconf, device="cpu")
        net.params = checkpoint.params_from_numpy(np_params, "cpu")
        net.fit(data)
        nets.append(net)
    one = ml.MultiLayerNetwork(tconf, device="cpu")
    one.params = checkpoint.params_from_numpy(np_params, "cpu")
    for b in batches:
        one.fit(DataSet(*b))
    for net in nets:
        for a, b in zip(tree_leaves(net.params), tree_leaves(one.params)):
            assert torch.equal(a, b)


def test_fit_initializes_params_and_lowers_the_score():
    _, tconf = _confs()
    net = ml.MultiLayerNetwork(tconf, device="cpu", seed=0)
    x, y = _batch(12)
    net.fit(x, y)
    first = net.score(x, y)
    for _ in range(5):
        net.fit(x, y)
    assert np.isfinite(first) and net.score(x, y) < first


def test_cg_pretrain_flag_and_dropout_training_paths_match_jax():
    jconf, tconf = _confs()
    x, y = _batch(13)
    # CG, cached and eager, and a `pretrain` conf (nothing pretrainable
    # here, so a plain finetune) each raised naming item 9 before; now each
    # `fit` reaches JAX's params from the same ones (1e-5)
    np_params = _numpy_params(jconf, seed=4)
    jcg = jconf.replace(confs=tuple(
        c.replace(optimization_algo="conjugate_gradient")
        for c in jconf.confs))
    for jc in (jcg, jconf.replace(pretrain=True)):
        jnet = jax_ml.MultiLayerNetwork(jc, seed=0).init()
        jnet.params = _jax_params(np_params)
        jnet.fit(x, y)
        for cached in (True, False):
            net = ml.MultiLayerNetwork(
                MultiLayerConfiguration.from_json(jc.to_json()),
                device="cpu", seed=0).init()
            net.params = checkpoint.params_from_numpy(np_params, "cpu")
            net.use_step_cache = cached
            net.fit(x, y)
            for layer, (tp, jp) in enumerate(zip(net.params, jnet.params)):
                for name in tp:
                    got, want = tp[name], np.asarray(jp[name])
                    if name != "bqkv":
                        _close(got, want, 1e-5)
                        continue
                    # the key bias's gradient is rounding noise, which
                    # Adam's first step turns into steps of up to lr (see
                    # test_fit_trajectory_matches_jax); q and v are held
                    n = 16
                    _close(got[:n], want[:n], 1e-5)
                    _close(got[2 * n:], want[2 * n:], 1e-5)
                    assert np.abs(got[n:2 * n].numpy()
                                  - want[n:2 * n]).max() <= 2 * 2 * jc.conf(
                                      layer).lr
    # dropout under training is ported (it raised before): the loss on a
    # key equals JAX's, masks and all, and fit trains
    jdrop = jconf.replace(confs=tuple(c.replace(dropout=0.1)
                                      for c in jconf.confs))
    dropped = MultiLayerConfiguration.from_json(jdrop.to_json())
    np_params = _numpy_params(jdrop, seed=4)
    key = jax.random.PRNGKey(5)
    from deeplearning4j_tpu_torch.nd import random as nd_random

    _close(ml.network_loss(dropped, checkpoint.params_from_numpy(
               np_params, "cpu"), torch.from_numpy(x), torch.from_numpy(y),
               nd_random.key_array(np.asarray(key))),
           jax_ml.network_loss(jdrop, _jax_params(np_params), jnp.asarray(x),
                               jnp.asarray(y), key), 1e-5)
    net = ml.MultiLayerNetwork(dropped, device="cpu", seed=0).init()
    net.fit(x, y)
    assert all(torch.isfinite(t).all() for t in tree_leaves(net.params))
    # inference is unaffected by the dropout rate
    ml.MultiLayerNetwork(dropped, device="cpu", seed=0).init().output(x)


def test_batch_norm_layers_name_their_roadmap_item():
    """BATCH_NORM is ported (it raised naming item 3 before): the training
    loss of a dense -> BatchNorm -> output net equals JAX's."""
    from deeplearning4j_tpu.nn import conf as jc

    base = jc.NeuralNetConfiguration(n_in=4, n_out=3)
    jconf = jc.MultiLayerConfiguration(confs=(
        base.replace(layer_type=jc.LayerType.DENSE),
        base.replace(layer_type=jc.LayerType.BATCH_NORM, n_in=3),
        base.replace(layer_type=jc.LayerType.OUTPUT, n_in=3, n_out=2)))
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    rng = np.random.RandomState(6)
    np_params = ({"W": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": rng.standard_normal(3).astype(np.float32)},
                 {"gamma": 1 + 0.1 * rng.standard_normal(3).astype(
                     np.float32),
                  "beta": 0.1 * rng.standard_normal(3).astype(np.float32),
                  "ema_mean": np.zeros(3, np.float32),
                  "ema_var": np.zeros(3, np.float32),
                  "ema_w": np.zeros((), np.float32)},
                 {"W": rng.standard_normal((3, 2)).astype(np.float32),
                  "b": np.zeros(2, np.float32)})
    x = rng.standard_normal((5, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 5)]
    params = checkpoint.params_from_numpy(np_params, "cpu")
    _close(ml.network_rowwise_loss(conf, params, torch.from_numpy(x),
                                   torch.from_numpy(y)),
           jax_ml.network_rowwise_loss(jconf, _jax_params(np_params),
                                       jnp.asarray(x), jnp.asarray(y)),
           1e-5)


def test_fit_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tconf = _confs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ml.MultiLayerNetwork(tconf).fit(*_batch(14))
    ml.MultiLayerNetwork(tconf, device="cpu").fit(*_batch(14))


@pytest.mark.cuda
def test_cuda_fit_runs_the_fused_backward_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from deeplearning4j_tpu_torch.nd import kernels

    _, tconf = _confs("bfloat16")
    net = ml.MultiLayerNetwork(tconf, device="cuda", seed=0).init()
    x, y = _batch(15)
    before = net.score(x, y)
    kernels.reset_launches()
    net.fit(x, y)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {
        name: 0 if name in ("lstm_cell", "scatter_add_rows") else 2
        for name in kernels.LAUNCHES}
    assert np.isfinite(net.score(x, y)) and np.isfinite(before)


# -------------------------------------------------------------- checkpoint

def test_port_checkpoint_loads_into_jax(tmp_path):
    jconf, tconf = _confs()
    net = ml.MultiLayerNetwork(tconf, device="cpu")
    net.params = checkpoint.params_from_numpy(_numpy_params(jconf, 16),
                                              "cpu")
    net.fit(*_batch(17))
    path = str(tmp_path / "ckpt")
    for step in (1, 2):  # the second save swaps the first out atomically
        assert checkpoint.save(path, net.params, conf=tconf,
                               step=step) == path
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]
    jparams, _, meta = jax_checkpoint.load(
        path, like_params=jax_ml.init_params(jconf, jax.random.PRNGKey(0)))
    assert meta["format_version"] == 1 and meta["step"] == 2
    loaded = jax_conf.MultiLayerConfiguration.from_json(
        (tmp_path / "ckpt" / "conf.json").read_text())
    x = _batch(18)[0]
    _close(net.output(x), jax_ml.network_output(loaded, jparams,
                                                jnp.asarray(x)), 1e-5)
    back = checkpoint.load_network(path, device="cpu")
    for a, b in zip(tree_leaves(back.params), tree_leaves(net.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ml_dtypes_present", [True, False])
def test_params_to_numpy_round_trips(monkeypatch, ml_dtypes_present):
    if not ml_dtypes_present:
        monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    rng = np.random.RandomState(19)
    params = ({"W": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32)), "h": torch.from_numpy(rng.standard_normal(5).astype(
            np.float32)).to(torch.bfloat16)},)
    arrays = checkpoint.params_to_numpy(params)
    assert arrays[0]["W"].dtype == np.float32
    assert arrays[0]["h"].dtype.name == ("bfloat16" if ml_dtypes_present
                                         else "float32")
    back = checkpoint.params_from_numpy(arrays, "cpu")
    assert torch.equal(back[0]["W"], params[0]["W"])
    assert torch.equal(back[0]["h"].to(torch.bfloat16), params[0]["h"])
    if ml_dtypes_present:
        assert back[0]["h"].dtype == torch.bfloat16

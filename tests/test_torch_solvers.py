"""The line-searched solvers and Hessian-free in the port vs the JAX package.

`backtrack` against JAX's (alpha and f within 1e-6), the probes each
iteration makes (JAX's `backtrack` counted under `jax.disable_jit()`, where
its `lax.while_loop` runs in Python), GD / CG / LBFGS / HF on JAX's own
quadratics (per-iteration scores within 1e-5 of max|score|, params after
the first iterations within 1e-5, and JAX's criteria at the end), the
Gauss-Newton product against dense algebra, HF on the Iris MLP, and the
cached `finetune` against the uncached solver, bitwise on the CPU.

Near a converged optimum a line search's accept/reject turns on the last
bits of f32 scores, so trajectories that agree to 1e-6 early can part
later; the params of a long run are therefore held to JAX's criteria, not
to JAX's params.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.optimize import linesearch as jax_ls  # noqa: E402
from deeplearning4j_tpu.optimize import solver as jax_solver  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as tconf  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.optimize import linesearch, solver  # noqa: E402
from deeplearning4j_tpu_torch.optimize.step_cache import TrainStepCache  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402

KEY = jax.random.PRNGKey(0)
TKEY = nd_random.key_array(np.asarray(KEY))
LINE_SEARCHED = ["gradient_descent", "conjugate_gradient", "lbfgs"]
ALGOS = LINE_SEARCHED + ["hessian_free"]

# tests/test_optimize.py's ill-conditioned quadratic 0.5 x'Ax - b'x
_A = np.diag([1.0, 10.0, 100.0]).astype(np.float32)
_B = np.array([1.0, -2.0, 3.0], np.float32)
_XSTAR = np.linalg.solve(_A, _B)


def _jax_quad(params, key=None):
    x = params["x"]
    return 0.5 * x @ jnp.asarray(_A) @ x - jnp.asarray(_B) @ x


def _quad(params, key=None):
    x = params["x"]
    return 0.5 * x @ torch.from_numpy(_A) @ x - torch.from_numpy(_B) @ x


def _confs(**kw):
    return (jax_conf.NeuralNetConfiguration(**kw),
            tconf.NeuralNetConfiguration(**kw))


def _f(v):
    return float(np.asarray(v))


# -------------------------------------------------------------- backtrack

def _ls_case(case):
    """(x, direction, grad, f0, max_iters, initial_step) of a quadratic."""
    x = np.array([5.0, 5.0, 5.0], np.float32)
    g = _A @ x - _B
    f0 = float(0.5 * x @ _A @ x - _B @ x)
    if case == "armijo":
        return x, -g, g, f0, 20, 1.0
    if case == "stpmax":   # |d| far above STPMAX * |x|: clamped
        return x, -1e6 * g, g, f0, 20, 1.0
    return x, g, g, f0, 5, 1.0   # ascent: every step fails


@pytest.mark.parametrize("case", ["armijo", "stpmax", "fails"])
def test_backtrack_matches_jax(case):
    x, d, g, f0, iters, step = _ls_case(case)
    calls = []

    def score(v):
        calls.append(1)
        return _quad({"x": v})

    alpha, f = linesearch.backtrack(score, torch.from_numpy(x),
                                    torch.from_numpy(d), torch.from_numpy(g),
                                    f0, max_iters=iters, initial_step=step)
    with jax.disable_jit():
        jcalls = []

        def jscore(v):
            jcalls.append(1)
            return _jax_quad({"x": v})

        ja, jf = jax_ls.backtrack(jscore, jnp.asarray(x), jnp.asarray(d),
                                  jnp.asarray(g), jnp.float32(f0),
                                  max_iters=iters, initial_step=step)
    np.testing.assert_allclose(_f(alpha), _f(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_f(f), _f(jf), rtol=1e-6, atol=1e-6)
    assert len(calls) == len(jcalls)
    if case == "fails":
        assert _f(alpha) == 0.0 and _f(f) == pytest.approx(f0)
        assert len(calls) == iters + 1
    else:
        xa = x + _f(alpha) * linesearch.prepare(
            torch.from_numpy(x), torch.from_numpy(d),
            torch.from_numpy(g))[0].numpy()
        assert _f(f) <= f0 + linesearch.ALF * _f(alpha) * float(
            g @ linesearch.prepare(torch.from_numpy(x), torch.from_numpy(d),
                                   torch.from_numpy(g))[0].numpy())
        assert np.isfinite(xa).all()
    if case == "stpmax":
        dc = linesearch.prepare(torch.from_numpy(x), torch.from_numpy(d),
                                torch.from_numpy(g))[0]
        stpmax = linesearch.STPMAX * max(float(np.linalg.norm(x)), 1.0)
        assert float(torch.linalg.vector_norm(dc)) == pytest.approx(
            stpmax, rel=1e-5)


def _jax_probe_counts(conf, params, loss):
    """The score calls of JAX's `backtrack` per iteration of a run, under
    `jax.disable_jit()` (the scan and the while loop run in Python)."""
    counts = []
    real = jax_ls.backtrack

    def counting(score_fn, *a, **kw):
        n = [0]

        def counted(v):
            n[0] += 1
            return score_fn(v)

        out = real(counted, *a, **kw)
        counts.append(n[0])
        return out

    jax_solver.backtrack = counting
    try:
        with jax.disable_jit():
            jax_solver.optimize(jax_solver.from_loss(loss), params, conf, KEY)
    finally:
        jax_solver.backtrack = real
    return counts


@pytest.mark.parametrize("algo", LINE_SEARCHED)
def test_probes_per_iteration_equal_jax(algo):
    jc, tc = _confs(optimization_algo=algo, num_iterations=12, lr=0.009)
    want = _jax_probe_counts(jc, {"x": jnp.array([5.0, 5.0, 5.0])},
                             _jax_quad)
    run = solver.LineSearchRun(solver.from_loss(_quad), tc, algo)
    run.setup({"x": torch.tensor([5.0, 5.0, 5.0])}, TKEY)
    run.drive(lambda name: run.segments[name]())
    got = run.books["probes"]
    # JAX's masked scan still searches after it is done; the port stops
    assert got == want[:len(got)]
    assert len(got) == len(want) or len(got) < tc.num_iterations
    assert run.books["reads"] == sum(got)


# ---------------------------------------------------- solvers on quadratics

@pytest.mark.parametrize("algo", ALGOS)
def test_solvers_minimize_the_quadratic_as_jax(algo):
    jc, tc = _confs(optimization_algo=algo, num_iterations=100, lr=0.009)
    p0 = np.array([5.0, 5.0, 5.0], np.float32)
    jp, js = jax_solver.optimize(jax_solver.from_loss(_jax_quad),
                                 {"x": jnp.asarray(p0)}, jc, KEY)
    tp, ts = solver.optimize(solver.from_loss(_quad),
                             {"x": torch.from_numpy(p0)}, tc, TKEY)
    js = np.asarray(js)
    np.testing.assert_allclose(ts, js, rtol=0,
                               atol=1e-5 * np.abs(js).max())
    # the first iterations, before the search works at rounding level
    jc5, tc5 = _confs(optimization_algo=algo, num_iterations=5, lr=0.009)
    jp5, _ = jax_solver.optimize(jax_solver.from_loss(_jax_quad),
                                 {"x": jnp.asarray(p0)}, jc5, KEY)
    tp5, _ = solver.optimize(solver.from_loss(_quad),
                             {"x": torch.from_numpy(p0)}, tc5, TKEY)
    np.testing.assert_allclose(tp5["x"].numpy(), np.asarray(jp5["x"]),
                               rtol=1e-5, atol=1e-5)
    # JAX's criteria (tests/test_optimize.py:25-44)
    f = float(_quad(tp))
    f_star = float(_quad({"x": torch.from_numpy(_XSTAR.astype(np.float32))}))
    f0 = float(_quad({"x": torch.from_numpy(p0)}))
    if algo == "gradient_descent":
        assert f - f_star < (f0 - f_star) * 1e-2
    else:
        assert f < f_star + 1e-2


def test_cg_beats_gd_on_the_ill_conditioned_quadratic():
    _, tc = _confs(optimization_algo="conjugate_gradient", num_iterations=60,
                   lr=0.009)
    out, _ = solver.optimize(solver.from_loss(_quad),
                             {"x": torch.tensor([5.0, 5.0, 5.0])}, tc, TKEY)
    f_star = float(_quad({"x": torch.from_numpy(_XSTAR.astype(np.float32))}))
    assert float(_quad(out)) - f_star < 1e-3


def test_custom_gradient_objective_with_cg_as_jax():
    """An Objective that is not autograd of a loss (the RBM's CD-k shape):
    tests/test_optimize.py:88-103."""
    def gs(params, key=None):
        x = params["x"]
        return ({"x": torch.from_numpy(_A) @ x - torch.from_numpy(_B)},
                _quad(params))

    def jgs(params, key):
        x = params["x"]
        return ({"x": jnp.asarray(_A) @ x - jnp.asarray(_B)},
                _jax_quad(params))

    jc, tc = _confs(optimization_algo="conjugate_gradient",
                    num_iterations=50)
    out, scores = solver.optimize(solver.Objective(gs, _quad),
                                  {"x": torch.zeros(3)}, tc, TKEY)
    jout, jscores = jax_solver.optimize(
        jax_solver.Objective(jgs, _jax_quad), {"x": jnp.zeros(3)}, jc, KEY)
    np.testing.assert_allclose(out["x"].numpy(), _XSTAR, atol=3e-2)
    jscores = np.asarray(jscores)
    np.testing.assert_allclose(scores, jscores, rtol=0,
                               atol=1e-5 * np.abs(jscores).max())


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("variant", ["zero_direction", "gradient_step",
                                     "negative_default", "no_termination"])
def test_terminations_and_step_functions_as_jax(algo, variant):
    kw = dict(optimization_algo=algo, num_iterations=15, lr=0.009,
              hf_cg_iterations=8)
    if variant == "zero_direction":
        kw["termination_conditions"] = ("eps", "norm2", "zero_direction")
    elif variant == "gradient_step":
        kw["step_function"] = "gradient"
    elif variant == "negative_default":
        kw["step_function"] = "negative_default"
    else:
        kw["termination_conditions"] = ()
    jc, tc = _confs(**kw)
    p0 = np.array([0.5, -0.25, 0.125], np.float32)
    jp, js = jax_solver.optimize(jax_solver.from_loss(_jax_quad),
                                 {"x": jnp.asarray(p0)}, jc, KEY)
    tp, ts = solver.optimize(solver.from_loss(_quad),
                             {"x": torch.from_numpy(p0)}, tc, TKEY)
    js = np.asarray(js)
    # negative_default steps uphill: both runs overflow to inf, then nan
    finite = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), finite)
    np.testing.assert_allclose(ts[finite], js[finite], rtol=1e-5,
                               atol=1e-5 * np.abs(js[finite]).max())
    if finite.all():
        np.testing.assert_allclose(tp["x"].numpy(), np.asarray(jp["x"]),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------- Hessian-free

def test_hf_solves_a_quadratic_in_one_outer_iteration():
    """tests/test_hessian_free.py:17-33, with a bare tensor as the params."""
    rng = np.random.RandomState(0)
    m = rng.randn(6, 6)
    A = (m @ m.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    ta, tb = torch.from_numpy(A), torch.from_numpy(b)
    _, tc = _confs(optimization_algo="hessian_free", num_iterations=8,
                   hf_cg_iterations=50, hf_initial_lambda=1e-6)
    x, scores = solver.optimize(
        solver.from_loss(lambda x: 0.5 * x @ ta @ x - tb @ x),
        torch.zeros(6), tc, TKEY)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-3,
                               atol=1e-3)
    jc, _ = _confs(optimization_algo="hessian_free", num_iterations=8,
                   hf_cg_iterations=50, hf_initial_lambda=1e-6)
    _, js = jax_solver.optimize(jax_solver.from_loss(
        lambda x, key: 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(b) @ x),
        jnp.zeros(6), jc, KEY)
    np.testing.assert_allclose(scores, np.asarray(js), rtol=1e-5, atol=1e-5)


def test_gauss_newton_product_matches_dense():
    """tests/test_hessian_free.py:36-49: GN of a linear predict under
    0.5|z - y|^2 is M'M."""
    rng = np.random.RandomState(1)
    M = torch.from_numpy(rng.randn(5, 4).astype(np.float32))
    y = torch.from_numpy(rng.randn(5).astype(np.float32))
    obj = solver.from_predict_loss(lambda p, key: M @ p,
                                   lambda z: 0.5 * torch.sum((z - y) ** 2))
    v = torch.from_numpy(rng.randn(4).astype(np.float32))
    gv = obj.gnvp(torch.zeros(4), v, None)
    np.testing.assert_allclose(gv.numpy(), (M.T @ (M @ v)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_weighted_gauss_newton_ignores_zero_weight_pad_rows():
    rng = np.random.RandomState(2)
    W = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
    x = torch.from_numpy(rng.randn(6, 3).astype(np.float32))
    y = torch.from_numpy(rng.rand(6, 4).astype(np.float32))
    pad_x = torch.cat([x, torch.zeros(2, 3)])
    pad_y = torch.cat([y, torch.zeros(2, 4)])
    w = torch.cat([torch.ones(6), torch.zeros(2)])

    def rows(labels, z):
        return 0.5 * torch.sum((labels - torch.sigmoid(z)) ** 2, dim=-1)

    v = {"W": torch.from_numpy(rng.randn(3, 4).astype(np.float32))}
    got = solver.weighted_predict_loss(lambda p, k: pad_x @ p["W"], rows,
                                       pad_y, w).gnvp({"W": W}, v, None)
    want = solver.weighted_predict_loss(lambda p, k: x @ p["W"], rows, y,
                                        torch.ones(6)).gnvp({"W": W}, v,
                                                            None)
    np.testing.assert_allclose(got["W"].numpy(), want["W"].numpy(),
                               rtol=1e-6, atol=1e-6)


def _iris():
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher

    data = IrisDataFetcher().fetch(150).normalize_zero_mean_unit_variance()
    return data.features.astype(np.float32), data.labels.astype(np.float32)


def _hf_iris_confs():
    base = jax_conf.NeuralNetConfiguration(
        optimization_algo="hessian_free", activation="tanh",
        num_iterations=30, lr=0.1, seed=3, hf_cg_iterations=24)
    jc = (jax_conf.list_builder(base, 2).hidden_layer_sizes([12], n_in=4,
                                                            n_out=3)
          .override(1, layer_type=jax_conf.LayerType.OUTPUT).build())
    return jc, tconf.MultiLayerConfiguration.from_json(jc.to_json())


@pytest.mark.parametrize("cached", [True, False])
def test_hf_trains_the_iris_mlp_as_jax(cached):
    """tests/test_hessian_free.py:51-: the port from JAX's initial params,
    against JAX's run (cached: the step cache's weighted Gauss-Newton
    product; eager: the network loss's)."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    x, y = _iris()
    jc, tc = _hf_iris_confs()
    jnet = JNet(jc, seed=3).init()
    net = ml.MultiLayerNetwork(tc, device="cpu", seed=3).init()
    net.params = checkpoint.params_from_numpy(jax.device_get(jnet.params),
                                              "cpu")
    net.use_step_cache = cached
    seen = []
    from deeplearning4j_tpu_torch.optimize.listeners import \
        IterationListener

    class Rec(IterationListener):
        def iteration_done(self, model, iteration, score):
            seen.append(score)

    net.set_listeners([Rec()])
    jnet.use_step_cache = cached
    jseen = []
    from deeplearning4j_tpu.optimize.listeners import \
        IterationListener as JIterationListener

    class JRec(JIterationListener):
        def iteration_done(self, model, iteration, score):
            jseen.append(score)

    jnet.set_listeners([JRec()])
    net.fit(x, y)
    jnet.fit(x, y)
    np.testing.assert_allclose(np.asarray(seen, np.float32),
                               np.asarray(jseen, np.float32), rtol=1e-4,
                               atol=1e-4)
    acc = float((net.predict(x) == y.argmax(1)).mean())
    assert acc > 0.9, acc


@pytest.mark.parametrize("layer,kw", [
    ("convolution", {}), ("lstm", {"lstm_impl": "fused"}),
    ("attention", {"attention_impl": "flash"})])
def test_hf_over_a_layer_without_jvp_names_it(layer, kw):
    confs = [tconf.NeuralNetConfiguration(layer_type=layer, n_in=4, n_out=4,
                                          **kw),
             tconf.NeuralNetConfiguration(layer_type="output", n_in=4,
                                          n_out=3,
                                          optimization_algo="hessian_free")]
    conf = tconf.MultiLayerConfiguration(confs=tuple(confs))
    with pytest.raises(NotImplementedError, match=f"layer 0 \\({layer}\\)"):
        solver.check_jvp(conf, cuda=False)
    # the plain paths of attention and the LSTM (the CPU's default) have
    # forward-mode derivatives
    if layer != "convolution":
        solver.check_jvp(conf.replace(confs=(confs[0].replace(
            **{k: "auto" for k in kw}), confs[1])), cuda=False)


def test_hf_needs_a_loss_or_a_gauss_newton_product():
    _, tc = _confs(optimization_algo="hessian_free", num_iterations=2)
    cd_like = solver.Objective(
        lambda p, k=None: ({"x": p["x"]}, _quad(p)), _quad)
    with pytest.raises(NotImplementedError, match="loss"):
        solver.optimize(cd_like, {"x": torch.ones(3)}, tc, TKEY)


# ----------------------------------------- the cached finetune, bitwise

def _mlp_confs(algo, iters=4):
    base = jax_conf.NeuralNetConfiguration(
        activation="tanh", weight_init="vi", lr=0.1, optimization_algo=algo,
        num_iterations=iters, seed=3, hf_cg_iterations=6)
    jc = (jax_conf.list_builder(base, 3).hidden_layer_sizes([8, 6], n_in=4,
                                                            n_out=3)
          .override(2, layer_type=jax_conf.LayerType.OUTPUT,
                    loss_function="mcxent").build())
    return jc, tconf.MultiLayerConfiguration.from_json(jc.to_json())


@pytest.mark.parametrize("algo", ALGOS)
def test_cached_finetune_equals_uncached_optimize_bitwise(algo):
    """tests/test_step_cache.py:108-130, the port against itself: the
    cached program (segments, for the line search) computes what the
    solver computes on the same row-weighted loss."""
    jc, tc = _mlp_confs(algo)
    x, y = _iris()
    x, y = torch.from_numpy(x[:24]), torch.from_numpy(y[:24])
    params0 = checkpoint.params_from_numpy(jax.device_get(
        jax_ml.init_params(jc, jax.random.PRNGKey(3))), "cpu")
    params = tuple({k: v.clone() for k, v in layer.items()}
                   for layer in params0)
    cache = TrainStepCache()
    scores = cache.finetune(tc, params, x, y, None)
    loss = ml.make_finetune_loss(tc)
    w = torch.ones(24)
    objective = solver.from_loss(lambda p: loss(p, x, y, w)[0])
    if algo == "hessian_free":
        from deeplearning4j_tpu_torch.nd.losses import get_rowwise

        objective = objective._replace(gnvp=solver.weighted_predict_loss(
            lambda p, k: ml.network_output(tc, p, x),
            get_rowwise("mcxent"), y, w).gnvp)
    want_p, want_s = solver.optimize(objective, params0,
                                     tc.conf(tc.n_layers - 1))
    np.testing.assert_array_equal(scores, want_s)
    for a, b in zip(tree_leaves(params), tree_leaves(want_p)):
        assert torch.equal(a, b)
    if algo in LINE_SEARCHED:
        books = cache.stats.solver
        assert books["iterations_run"] == len(books["probes"]) > 0
        assert books["host_reads"] == sum(books["probes"])
        assert books["graphs_captured"] == 0   # no graph on the CPU


def test_bound_objective_and_batched_from_loss():
    bo = solver.batched_from_loss(
        lambda p, x, y, k=None: torch.sum((p["w"] * x - y) ** 2))
    obj = bo.bind(torch.ones(3), torch.zeros(3))
    g, s = obj.grad_and_score({"w": torch.full((3,), 2.0)})
    assert float(s) == 12.0
    np.testing.assert_array_equal(g["w"].numpy(), [4.0, 4.0, 4.0])
    assert float(obj.loss({"w": torch.ones(3)})) == 3.0

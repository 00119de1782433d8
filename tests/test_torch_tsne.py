"""The port's t-SNE (`deeplearning4j_tpu_torch/plot/`) held to the JAX
package's on the CPU: P within 1e-5, the initial embedding JAX's normal
draw, 20 gradient iterations from JAX's start within 1e-4, the KL history
within 1e-4 relative, and Barnes-Hut (a host-side copy over the port's
trees) equal to JAX's; then the cases of tests/test_tsne.py on the port.

The t-SNE iteration is chaotic: at learning rate 10 and exaggeration 4
on these 60 points the gap between two float32 runs that differ in
rounding grows about tenfold every 4 iterations (4e-10 after one, 5e-4
after 20, 1e-2 after 30), and at the default rate of 500 and
exaggeration 12 it reaches the embedding's own size within 12. So the
trajectory check runs 20 iterations at rate 10 on the plain P (measured
2.5e-6), the KL history a run of 101 iterations at rate 2 and momentum
0.3 (measured 2e-5 relative at iteration 100), and longer runs are
judged on quality, as JAX's own test judges them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.plot import BarnesHutTsne as JaxBH  # noqa: E402
from deeplearning4j_tpu.plot import Tsne as JaxTsne  # noqa: E402
from deeplearning4j_tpu.plot import tsne as jax_tsne  # noqa: E402
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne  # noqa: E402
from deeplearning4j_tpu_torch.plot import tsne as port_tsne  # noqa: E402


def _blob_data(n_per=30, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(n_per, 10) * 0.3
    b = rng.randn(n_per, 10) * 0.3 + 4.0
    x = np.vstack([a, b]).astype(np.float32)
    labels = np.array([0] * n_per + [1] * n_per)
    return x, labels


def _separation(y, labels):
    ya, yb = y[labels == 0], y[labels == 1]
    between = np.linalg.norm(ya.mean(0) - yb.mean(0))
    within = (np.linalg.norm(ya - ya.mean(0), axis=1).mean() +
              np.linalg.norm(yb - yb.mean(0), axis=1).mean()) / 2
    return between / max(within, 1e-9)


def _jax_y0(n, seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, 2))
                      * 1e-4)


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("perplexity", [5.0, 10.0, 20.0])
def test_compute_p_matches_jax(perplexity):
    """Within 1e-5 (measured 2.5e-7 at max P 7e-3: the squared distances
    of |x|^2 - 2 x.y + |y|^2 carry the two products' different
    cancellation noise)."""
    x, _ = _blob_data()
    want = np.asarray(JaxTsne(perplexity=perplexity).compute_p(x))
    got = Tsne(perplexity=perplexity, device="cpu").compute_p(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_initial_y_is_jaxs_normal_draw():
    """JAX's `normal(PRNGKey(seed), (n, 2)) * 1e-4`, within 3 float32 ulps
    (`nd/random.normal_dtype`)."""
    for seed in (0, 5):
        got = Tsne(seed=seed, device="cpu").initial_y(60).numpy()
        want = _jax_y0(60, seed)
        np.testing.assert_array_max_ulp(got, want, maxulp=3)


def test_twenty_gradient_iterations_match_jax():
    """20 iterations of the gradient and the gains+momentum update from
    JAX's P and start: within 1e-4 (measured 2.5e-6 at |y| ~ 5)."""
    x, _ = _blob_data()
    p = np.asarray(JaxTsne(perplexity=10.0).compute_p(x))
    y0 = _jax_y0(60)
    jy, jinc, jg = jnp.asarray(y0), jnp.zeros((60, 2)), jnp.ones((60, 2))
    ty = torch.from_numpy(y0.copy())
    tinc, tg = torch.zeros_like(ty), torch.ones_like(ty)
    tp = torch.from_numpy(p)
    for _ in range(20):
        grad, _ = jax_tsne._tsne_grad(jy, jnp.asarray(p))
        jy, jinc, jg = jax_tsne._update(jy, grad, jinc, jg, 0.5, 10.0, 0.01)
        grad_t, _ = port_tsne.tsne_grad(ty, tp)
        ty, tinc, tg = port_tsne.tsne_update(ty, grad_t, tinc, tg, 0.5, 10.0,
                                             0.01)
    assert np.abs(np.asarray(jy)).max() > 1e-2  # the embedding moved
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_gradient_and_kl_match_jax():
    x, _ = _blob_data()
    p = np.asarray(JaxTsne(perplexity=10.0).compute_p(x))
    y = np.random.RandomState(1).randn(60, 2).astype(np.float32)
    jgrad, jkl = jax_tsne._tsne_grad(jnp.asarray(y), jnp.asarray(p))
    grad, kl = port_tsne.tsne_grad(torch.from_numpy(y), torch.from_numpy(p))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6,
                               rtol=1e-4)
    assert float(kl) == pytest.approx(float(jkl), rel=1e-5)


def test_kl_history_matches_jax():
    """`calculate` from JAX's start: a KL entry every 100 iterations,
    within 1e-4 relative of JAX's."""
    x, _ = _blob_data()
    kw = dict(perplexity=10.0, max_iter=101, learning_rate=2.0,
              exaggeration=4.0, stop_lying_iter=100, momentum=0.3,
              final_momentum=0.3)
    j = JaxTsne(**kw)
    j.calculate(x)
    t = Tsne(device="cpu", **kw)
    t.initial_y = lambda n: torch.from_numpy(_jax_y0(n))
    t.calculate(x)
    assert len(t.kl_history) == len(j.kl_history) == 2
    np.testing.assert_allclose(t.kl_history, j.kl_history, rtol=1e-4)
    assert t.kl_history[-1] < t.kl_history[0]


def test_barnes_hut_equals_jax():
    """A host-side copy over the port's trees: bitwise JAX's sparse P and
    embedding."""
    x, _ = _blob_data(n_per=15, seed=1)
    j = JaxBH(max_iter=30, perplexity=5.0, theta=0.5, seed=0)
    t = BarnesHutTsne(max_iter=30, perplexity=5.0, theta=0.5, seed=0)
    for a, b in zip(t.compute_gaussian_perplexity(x),
                    j.compute_gaussian_perplexity(x)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.calculate(x), j.calculate(x))


# --------------------------------------------------- tests/test_tsne.py

def test_p_rows_sum_and_symmetry():
    x, _ = _blob_data(n_per=20)
    p = Tsne(perplexity=10.0, device="cpu").compute_p(x).numpy()
    assert np.allclose(p, p.T, atol=1e-7)
    assert np.isclose(p.sum(), 1.0, atol=1e-5)
    assert np.all(np.diag(p) < 1e-6)


def test_embedding_separates_blobs():
    x, labels = _blob_data(n_per=20)
    t = Tsne(max_iter=600, perplexity=10.0, seed=0, learning_rate=10.0,
             final_momentum=0.5, stop_lying_iter=100, exaggeration=4.0,
             device="cpu")
    y = t.calculate(x)
    assert y.shape == (40, 2) and np.all(np.isfinite(y))
    assert _separation(y, labels) > 2.0
    assert t.kl_history[-1] < t.kl_history[0]


def test_barnes_hut_sparse_p_valid_and_separates():
    x, labels = _blob_data(n_per=15, seed=1)
    bh = BarnesHutTsne(max_iter=150, perplexity=5.0, theta=0.5, seed=0)
    rows, cols, vals = bh.compute_gaussian_perplexity(x)
    assert rows[-1] == len(cols) == len(vals)
    assert np.isclose(vals.sum(), 1.0, atol=1e-6) and np.all(vals >= 0)
    y = bh.calculate(x)
    assert y.shape == (30, 2) and np.all(np.isfinite(y))
    assert _separation(y, labels) > 2.0
    assert bh.params() is y


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tsne()

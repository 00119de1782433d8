"""The port's clustering (`deeplearning4j_tpu_torch/clustering/`) held to
the JAX package's on the CPU: the k-means++ seeds bitwise (numpy's
summation order replayed on the tensor path), Lloyd's assignments and
iteration count equal and its centers within 1e-5, each strategy
condition stopping at JAX's iteration with the same assignment, the
trees' queries equal (they are copies); then the cases of
tests/test_clustering.py on the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu import clustering as jc  # noqa: E402
from deeplearning4j_tpu.clustering import kmeans as jax_kmeans  # noqa: E402
from deeplearning4j_tpu_torch.clustering import (  # noqa: E402
    BaseClusteringAlgorithm, ClusteringOptimizationType,
    ConvergenceCondition, FixedClusterCountStrategy,
    FixedIterationCountCondition, KDTree, KMeansClustering,
    OptimisationStrategy, QuadTree, SpTree, VPTree)
from deeplearning4j_tpu_torch.clustering import kmeans  # noqa: E402
from deeplearning4j_tpu_torch.clustering.strategy import (  # noqa: E402
    IterationCountMultipleOfCondition, IterationHistory, IterationInfo)


def _two_blobs(n=60, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(n // 2, 3) * 0.2 + np.array([0.0, 0.0, 0.0])
    b = rng.randn(n // 2, 3) * 0.2 + np.array([5.0, 5.0, 5.0])
    return np.vstack([a, b]).astype(np.float32)


def _blobs(n=1500, k=8, d=16, seed=0, spread=6.0):
    """k Gaussian blobs in d dims, unit variance, centers N(0, spread^2)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * spread
    return (centers[rng.randint(k, size=n)]
            + rng.randn(n, d)).astype(np.float32)


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("d", [3, 16, 130, 784])
def test_row_sums_are_numpys_bit_for_bit(d):
    """`row_sq_dists` replays numpy's pairwise summation (8 running sums,
    halving past 128): exact for row lengths on each side of 8 and 128."""
    x = (np.random.RandomState(d).randn(300, d) * 30).astype(np.float32)
    want = ((x - x[7]) ** 2).sum(1)
    got = kmeans.row_sq_dists(torch.from_numpy(x), torch.from_numpy(x[7]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,d", [(8, 16), (5, 3), (20, 130)])
def test_kmeanspp_seeds_are_jaxs(k, d):
    """Exact: the rows JAX's host code draws, from a tensor and from a
    numpy matrix."""
    x = _blobs(n=900, k=k, d=d, seed=k)
    want = jax_kmeans.kmeanspp_seed(x, k, np.random.RandomState(3))
    got = kmeans.kmeanspp_seed(torch.from_numpy(x), k,
                               np.random.RandomState(3))
    np.testing.assert_array_equal(got.numpy(), want)
    host = kmeans.kmeanspp_seed(x, k, np.random.RandomState(3))
    np.testing.assert_array_equal(host, want)


@pytest.mark.parametrize("k,tol,max_iters", [(8, 1e-4, 100), (8, 1e-4, 2),
                                             (12, 1e-3, 100)])
def test_lloyd_matches_jax(k, tol, max_iters):
    """On separated blobs: JAX's iteration count, its assignment exactly,
    its centers within 1e-5 (measured 2e-6 at |c| ~ 18)."""
    x = _blobs(k=8)
    init = jax_kmeans.kmeanspp_seed(x, k, np.random.RandomState(1))
    jcen, jassign, jit = jax_kmeans._lloyd(jnp.asarray(x), jnp.asarray(init),
                                           max_iters, tol)
    cen, assign, it = kmeans.lloyd(torch.from_numpy(x),
                                   torch.from_numpy(init), max_iters, tol)
    assert it == int(jit)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
    np.testing.assert_allclose(cen.numpy(), np.asarray(jcen), atol=1e-5,
                               rtol=0)


def test_fast_path_cluster_set_matches_jax():
    x = _blobs(k=6, seed=4)
    want = jc.KMeansClustering(k=6, seed=2).apply_to(x)
    algo = KMeansClustering(k=6, seed=2, device="cpu")
    got = algo.apply_to(x)
    assert got.assignments == want.assignments
    np.testing.assert_allclose(got.centers, want.centers, atol=1e-5, rtol=0)
    assert algo.iterations >= 2


def _both(setup_kw=None, strategy=None, x=None, seed=1):
    """(JAX algorithm, port algorithm, JAX ClusterSet, port ClusterSet)."""
    x = _blobs() if x is None else x
    if strategy is not None:
        ja = jc.BaseClusteringAlgorithm.setup(strategy(jc), seed=seed)
        ta = BaseClusteringAlgorithm.setup(strategy(None), seed=seed,
                                           device="cpu")
    else:
        ja = jc.KMeansClustering.setup(seed=seed, **setup_kw)
        ta = KMeansClustering.setup(seed=seed, device="cpu", **setup_kw)
    return ja, ta, ja.apply_to(x), ta.apply_to(x)


def _port_or_jax(mod):
    if mod is None:
        import deeplearning4j_tpu_torch.clustering as port
        return port
    return mod


@pytest.mark.parametrize("setup_kw", [
    dict(k=12, max_iterations=7),
    dict(k=12, min_distribution_variation_rate=0.01),
    dict(k=12, max_iterations=9, distance_fn="manhattan"),
    dict(k=12, max_iterations=9, distance_fn="cosinesimilarity"),
    dict(k=3, min_distribution_variation_rate=0.001),
], ids=["fixed", "convergence", "manhattan", "cosine", "convergence-k3"])
def test_strategy_conditions_stop_at_jaxs_iteration(setup_kw):
    """Each condition stops at JAX's iteration, with JAX's per-iteration
    location changes, strategy flags and final assignment; centers within
    1e-5. Distance variances within 1e-3 relative (measured 8e-5): a point
    that is a center has a distance of sqrt(|x|^2 - 2 x.c + |c|^2), the
    root of the formula's cancellation noise (~1e-2 here), and the two
    packages' matrix products leave different noise."""
    ja, ta, cj, ct = _both(setup_kw)
    assert ta.history.iteration_count == ja.history.iteration_count
    for a, b in zip(ta.history.infos, ja.history.infos):
        assert a.point_location_change == b.point_location_change
        assert a.strategy_applied == b.strategy_applied
        np.testing.assert_array_equal(a.counts, np.asarray(b.counts))
        assert a.distance_variance == pytest.approx(b.distance_variance,
                                                    rel=1e-3)
    assert ct.assignments == cj.assignments
    np.testing.assert_allclose(ct.centers, cj.centers, atol=1e-5, rtol=0)


def test_variance_condition_stops_at_jaxs_iteration():
    ja, ta, cj, ct = _both(strategy=lambda m: _port_or_jax(m)
                           .FixedClusterCountStrategy.setup(3)
                           .end_when_variance_variation_less_than(0.01, 2),
                           seed=0)
    assert ta.history.iteration_count == ja.history.iteration_count >= 3
    assert ct.assignments == cj.assignments


def test_empty_cluster_case_matches_jax():
    """tests/test_clustering.py's k = 3 on two tight blobs: JAX's
    iterations, flags and assignment, every cluster non-empty."""
    x = _two_blobs(n=40, seed=1)
    ja, ta, cj, ct = _both(dict(k=3, max_iterations=20), x=x, seed=5)
    assert ([i.strategy_applied for i in ta.history.infos]
            == [i.strategy_applied for i in ja.history.infos])
    assert ct.assignments == cj.assignments
    assert all(len(c.points) > 0 for c in ct.clusters)


@pytest.mark.parametrize("empties", [(2,), (0, 3)])
def test_empty_cluster_split_matches_jax(empties):
    """The repair itself on an iteration with empty slots (k-means++ seeds
    rarely leave one): the port's split moves JAX's rows into JAX's slots,
    most spread-out source first, and reports it applied."""
    rng = np.random.RandomState(len(empties))
    k, n = 5, 40
    x = rng.randn(n, 3).astype(np.float32)
    live = [c for c in range(k) if c not in empties]
    assign = np.asarray(live)[rng.randint(len(live), size=n)]
    centers = rng.randn(k, 3).astype(np.float32)
    dist = np.linalg.norm(x - centers[assign], axis=1).astype(np.float32)
    one_hot = np.eye(k, dtype=np.float32)[assign]
    counts = one_hot.sum(0)
    stats = {"counts": counts,
             "avg_dist": (one_hot * dist[:, None]).sum(0)
             / np.maximum(counts, 1.0),
             "max_dist": (one_hot * dist[:, None]).max(0)}
    jalgo = jc.KMeansClustering.setup(k, max_iterations=3)
    talgo = KMeansClustering.setup(k, max_iterations=3, device="cpu")
    want, want_applied = jalgo._apply_strategy(
        centers, x, assign, dist, {kk: jnp.asarray(v)
                                   for kk, v in stats.items()})
    got, applied = talgo._apply_strategy(
        torch.from_numpy(centers), torch.from_numpy(x),
        torch.from_numpy(assign), torch.from_numpy(dist),
        {kk: torch.from_numpy(v) for kk, v in stats.items()}, counts)
    assert applied is want_applied is True
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(np.asarray(want), centers)


def test_optimisation_strategy_matches_jax():
    def strat(m):
        m = _port_or_jax(m)
        s = (m.OptimisationStrategy.setup(2)
             .optimize(m.ClusteringOptimizationType
                       .MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE, 0.5)
             .optimize_when_iteration_count_multiple_of(2))
        return s.end_when_iteration_count_equals(9)
    ja, ta, cj, ct = _both(strategy=strat, x=_two_blobs(), seed=0)
    flags = [i.strategy_applied for i in ja.history.infos]
    assert [i.strategy_applied for i in ta.history.infos] == flags
    assert ta.history.iteration_count == ja.history.iteration_count
    assert ct.assignments == cj.assignments


def test_trees_answer_as_jaxs():
    """The trees are copies: the same neighbours, ranges and forces."""
    rng = np.random.RandomState(0)
    data = rng.rand(120, 4)
    q = rng.rand(4)
    assert ([i for _, _, i in KDTree.build(data).knn(q, 6)]
            == [i for _, _, i in jc.KDTree.build(data).knn(q, 6)])
    assert (sorted(i for _, i in KDTree.build(data).range([0.2] * 4,
                                                          [0.7] * 4))
            == sorted(i for _, i in jc.KDTree.build(data).range([0.2] * 4,
                                                                [0.7] * 4)))
    for metric in ("euclidean", "cosine"):
        assert (VPTree(data, distance=metric).words_nearest(q, 7)
                == jc.VPTree(data, distance=metric).words_nearest(q, 7))
    pts2 = rng.randn(40, 2)
    for tree, jtree in ((QuadTree.build(pts2), jc.QuadTree.build(pts2)),
                        (SpTree.build(pts2), jc.SpTree.build(pts2))):
        f, jf = np.zeros(2), np.zeros(2)
        sq = tree.compute_non_edge_forces(pts2[3], 0.5, f)
        jsq = jtree.compute_non_edge_forces(pts2[3], 0.5, jf)
        assert sq == jsq
        np.testing.assert_array_equal(f, jf)


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeansClustering(k=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeansClustering.setup(2)


# ---------------------------------------------- tests/test_clustering.py

def test_two_blobs_separate():
    cs = KMeansClustering(k=2, seed=3, device="cpu").apply_to(_two_blobs())
    assert len(cs.clusters) == 2
    first_half = {cs.assignments[str(i)] for i in range(30)}
    second_half = {cs.assignments[str(i)] for i in range(30, 60)}
    assert len(first_half) == 1 and len(second_half) == 1
    assert first_half != second_half
    centers = sorted(cs.centers.tolist())
    assert np.allclose(centers[0], [0, 0, 0], atol=0.5)
    assert np.allclose(centers[1], [5, 5, 5], atol=0.5)


def test_nearest_cluster_and_stats():
    cs = KMeansClustering(k=2, seed=1, device="cpu").apply_to(_two_blobs())
    c = cs.nearest_cluster(np.array([5.0, 5.0, 5.0], np.float32))
    assert np.allclose(c.center, [5, 5, 5], atol=0.5)
    assert cs.average_point_distance_to_center() < 1.0


def test_too_few_points_raises():
    with pytest.raises(ValueError):
        KMeansClustering(k=5, device="cpu").apply_to(
            np.zeros((3, 2), np.float32))


def test_kmeans_setup_overloads():
    algo = KMeansClustering.setup(2, max_iterations=25, device="cpu")
    assert isinstance(algo, BaseClusteringAlgorithm)
    assert isinstance(algo.strategy.termination_condition,
                      FixedIterationCountCondition)
    algo2 = KMeansClustering.setup(2, min_distribution_variation_rate=0.01,
                                   device="cpu")
    assert isinstance(algo2.strategy.termination_condition,
                      ConvergenceCondition)


def test_strategy_framework_clusters_blobs():
    cs = KMeansClustering.setup(2, max_iterations=30, seed=3,
                                device="cpu").apply_to(_two_blobs())
    first = {cs.assignments[str(i)] for i in range(30)}
    second = {cs.assignments[str(i)] for i in range(30, 60)}
    assert len(first) == 1 and len(second) == 1 and first != second


def test_fixed_vs_convergence_stopping_behavior():
    x = _two_blobs()
    fixed = KMeansClustering.setup(2, max_iterations=17, seed=0, device="cpu")
    fixed.apply_to(x)
    assert fixed.history.iteration_count == 17
    conv = KMeansClustering.setup(2, min_distribution_variation_rate=0.05,
                                  seed=0, device="cpu")
    conv.apply_to(x)
    assert 2 <= conv.history.iteration_count < 10


def test_optimisation_strategy_splits_wide_clusters():
    strat = (OptimisationStrategy.setup(2)
             .optimize(ClusteringOptimizationType
                       .MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE, 5.0)
             .optimize_when_iteration_count_multiple_of(1))
    strat.end_when_iteration_count_equals(15)
    cs = BaseClusteringAlgorithm.setup(strat, seed=0, device="cpu").apply_to(
        _two_blobs())
    for c in cs.clusters:
        if c.points:
            assert np.mean([c.distance_to_center(p) for p in c.points]) < 5.0


def test_manhattan_distance_function():
    cs = KMeansClustering.setup(2, max_iterations=20, distance_fn="manhattan",
                                seed=2, device="cpu").apply_to(_two_blobs())
    first = {cs.assignments[str(i)] for i in range(30)}
    second = {cs.assignments[str(i)] for i in range(30, 60)}
    assert first != second


def test_kdtree_knn_insert_and_range():
    rng = np.random.RandomState(0)
    data = rng.rand(200, 4)
    q = rng.rand(4)
    got = [i for _, _, i in KDTree.build(data).knn(q, 5)]
    assert got == np.argsort(np.linalg.norm(data - q, axis=1))[:5].tolist()
    tree = KDTree(2)
    for p in [[0, 0], [1, 1], [2, 2], [5, 5]]:
        tree.insert(p)
    d, pt = tree.nn([1.1, 1.1])
    assert np.allclose(pt, [1, 1])
    assert d == pytest.approx(np.sqrt(2 * 0.1 ** 2), abs=1e-9)
    box = KDTree.build(np.array([[0.1, 0.1], [0.5, 0.5], [0.9, 0.9],
                                 [2.0, 2.0]]))
    assert sorted(i for _, i in box.range([0.0, 0.0], [1.0, 1.0])) == [0, 1, 2]


def test_vptree_knn_and_cosine():
    rng = np.random.RandomState(1)
    data = rng.rand(150, 8)
    q = rng.rand(8)
    want = np.argsort(np.linalg.norm(data - q, axis=1))[:7].tolist()
    assert VPTree(data).words_nearest(q, 7) == want
    cos = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.01], [-1.0, 0.0]])
    assert set(VPTree(cos, distance="cosine").words_nearest(
        np.array([1.0, 0.0]), 2)) == {0, 2}


def test_quadtree_and_sptree_forces_exact_at_theta_zero():
    data = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    tree = QuadTree.build(data)
    assert tree.cum_size == 4
    assert np.allclose(tree.center_of_mass, [0.5, 0.5])
    rng = np.random.RandomState(4)
    for build, pts in ((QuadTree.build, rng.randn(30, 2)),
                       (SpTree.build, rng.randn(25, 3))):
        f = np.zeros(pts.shape[1])
        sum_q = build(pts).compute_non_edge_forces(pts[5], 0.0, f)
        diff = pts[5] - pts
        d2 = (diff ** 2).sum(1)
        q = 1.0 / (1.0 + d2)
        mask = d2 > 0
        assert np.allclose(f, ((q ** 2)[mask, None] * diff[mask]).sum(0),
                           atol=1e-9)
        assert sum_q == pytest.approx(q[mask].sum(), abs=1e-9)


def test_sptree_counts_theta_and_edge_forces():
    rng = np.random.RandomState(3)
    data = rng.randn(50, 3)
    tree = SpTree.build(data)
    assert tree.cum_size == 50
    assert np.allclose(tree.center_of_mass, data.mean(0), atol=1e-9)
    data2 = np.random.RandomState(5).randn(100, 2)
    t2 = SpTree.build(data2)
    exact, approx = np.zeros(2), np.zeros(2)
    t2.compute_non_edge_forces(data2[0], 0.0, exact)
    t2.compute_non_edge_forces(data2[0], 0.5, approx)
    assert np.linalg.norm(exact - approx) < 0.1 * max(
        np.linalg.norm(exact), 1e-9) + 0.05
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]])
    pos_f = SpTree.compute_edge_forces(pts, np.array([0, 2, 2, 2]),
                                       np.array([1, 2]), np.array([0.6, 0.4]))
    want0 = (0.6 / 2.0) * np.array([-1.0, 0.0]) + \
        (0.4 / 5.0) * np.array([0.0, -2.0])
    assert np.allclose(pos_f[0], want0)
    assert np.allclose(pos_f[1], 0) and np.allclose(pos_f[2], 0)


def test_multiple_of_condition_fires_periodically():
    cond = IterationCountMultipleOfCondition(3)
    h = IterationHistory()
    fired = []
    for i in range(1, 10):
        h.infos.append(IterationInfo(index=i - 1, point_location_change=0,
                                     distance_variance=1.0,
                                     counts=np.zeros(2)))
        fired.append(cond.is_satisfied(h))
    assert fired == [False, False, True] * 3


def test_degenerate_identical_points_terminate():
    algo = KMeansClustering.setup(3, max_iterations=5, seed=0, device="cpu")
    cs = algo.apply_to(np.ones((12, 3), np.float32))
    assert algo.history.iteration_count <= 6
    assert len(cs.clusters) == 3


def test_strategy_shared_between_algorithms_not_mutated():
    strat = FixedClusterCountStrategy.setup(2)
    BaseClusteringAlgorithm.setup(strat, device="cpu")
    assert strat.termination_condition is None
    strat0 = FixedClusterCountStrategy.setup(2) \
        .end_when_iteration_count_equals(0)
    algo = BaseClusteringAlgorithm.setup(strat0, seed=0, device="cpu")
    cs = algo.apply_to(_two_blobs())
    assert algo.history.iteration_count == 0
    assert len(cs.clusters) == 2

"""The rest of the port's `utils/` on the CPU, held to the JAX package's.

The cases of tests/test_utils.py (math, Viterbi, collections, the disk
queue, serialization, string grids, time series, the thread pool and
archives) and of tests/test_profiling.py run on the port's modules, and
where both packages compute a value the port's must equal the JAX
package's on the same inputs. The port's `Tracer` records with
`torch.profiler` and writes a Chrome trace that names an `annotate` span.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.utils import math_utils as jax_mu  # noqa: E402
from deeplearning4j_tpu.utils import string_grid as jax_sg  # noqa: E402
from deeplearning4j_tpu.utils import timeseries as jax_ts  # noqa: E402
from deeplearning4j_tpu.utils import Viterbi as JaxViterbi  # noqa: E402
from deeplearning4j_tpu_torch.utils import (  # noqa: E402
    Counter, CounterMap, DiskBasedQueue, Index, MultiDimensionalMap,
    Viterbi, load_object, save_object)
from deeplearning4j_tpu_torch.utils import math_utils as mu  # noqa: E402
from deeplearning4j_tpu_torch.utils.profiling import (  # noqa: E402
    METRICS, MetricsRegistry, StepTimer, ThroughputMeter,
    TimingIterationListener, Tracer)
from deeplearning4j_tpu_torch.utils.string_grid import (  # noqa: E402
    StringCluster, StringGrid, fingerprint)
from deeplearning4j_tpu_torch.utils.timeseries import (  # noqa: E402
    difference, lagged, moving_window_matrix)


class TestMathUtils:
    def test_normalize_and_discretize(self):
        assert mu.normalize(5.0, 0.0, 10.0) == 0.5
        assert mu.discretize(0.95, 0.0, 1.0, 10) == 9
        assert mu.discretize(-5.0, 0.0, 1.0, 10) == 0

    def test_entropy_information_gain(self):
        assert mu.entropy([0.5, 0.5]) == pytest.approx(np.log(2))
        assert mu.entropy([1.0]) == 0.0
        ig = mu.information_gain([0.5, 0.5], [[1.0], [1.0]], [0.5, 0.5])
        assert ig == pytest.approx(np.log(2))

    def test_log_add_matches_direct(self):
        a, b = np.log(0.3), np.log(0.4)
        assert mu.log_add(a, b) == pytest.approx(np.log(0.7))
        assert mu.log_sum([a, b, np.log(0.3)]) == pytest.approx(0.0,
                                                               abs=1e-12)

    def test_stats(self):
        x = [1.0, 2.0, 3.0, 4.0]
        assert mu.mean(x) == 2.5
        assert mu.variance(x) == pytest.approx(np.var(x, ddof=1))
        assert mu.correlation(x, [2.0, 4.0, 6.0, 8.0]) == pytest.approx(1.0)
        assert mu.euclidean_distance([0, 0], [3, 4]) == 5.0

    def test_bernoullis(self):
        assert mu.bernoullis(0.5, 2, 1) == pytest.approx(0.5)

    def test_every_function_equals_jax_on_seeded_inputs(self):
        rng = np.random.RandomState(0)
        p = rng.dirichlet(np.ones(6))
        a, b = rng.randn(9), rng.randn(9)
        logs = np.log(rng.rand(7))
        cases = [
            ("normalize", (0.3, -1.0, 2.0)), ("clamp", (3.0, -1.0, 2.0)),
            ("round_to_n_decimals", (3.14159, 3)), ("entropy", (p,)),
            ("information_gain", (p, [p[:3], p[3:]], [0.4, 0.6])),
            ("ssum", (a,)), ("sum_of_squares", (a,)), ("mean", (a,)),
            ("variance", (a,)), ("correlation", (a, b)),
            ("euclidean_distance", (a, b)), ("manhattan_distance", (a, b)),
            ("sigmoid", (0.7,)), ("log_add", (logs[0], logs[1])),
            ("log_sum", (logs,)), ("bernoullis", (0.3, 7, 2)),
            ("discretize", (0.37, 0.0, 1.0, 8)), ("next_power_of_2", (37,)),
        ]
        for name, args in cases:
            assert getattr(mu, name)(*args) == getattr(jax_mu, name)(*args), \
                name
        x, y = mu.xor_sample((5, 3), np.random.RandomState(4))
        jx, jy = jax_mu.xor_sample((5, 3), np.random.RandomState(4))
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


class TestViterbi:
    def test_decodes_most_likely_path(self):
        # 2 states; strong self-transitions; observations flip mid-sequence
        log_trans = np.log(np.array([[0.9, 0.1], [0.1, 0.9]]))
        v = Viterbi(2, log_init=np.log([0.5, 0.5]), log_trans=log_trans,
                    device="cpu")
        probs = np.array([[0.9, 0.1], [0.8, 0.2], [0.9, 0.1],
                          [0.1, 0.9], [0.2, 0.8], [0.1, 0.9]])
        path, best = v.decode_from_probs(probs)
        assert path.tolist() == [0, 0, 0, 1, 1, 1]
        assert np.isfinite(best)
        jpath, jbest = JaxViterbi(2, log_init=np.log([0.5, 0.5]),
                                  log_trans=log_trans).decode_from_probs(
            probs)
        assert path.tolist() == np.asarray(jpath).tolist()
        assert best == pytest.approx(float(jbest), rel=1e-6)

    def test_sticky_transitions_smooth_noise(self):
        # a single noisy observation should not flip the state
        log_trans = np.log(np.array([[0.99, 0.01], [0.01, 0.99]]))
        v = Viterbi(2, log_trans=log_trans, device="cpu")
        probs = np.array([[0.9, 0.1], [0.4, 0.6], [0.9, 0.1], [0.9, 0.1]])
        path, _ = v.decode_from_probs(probs)
        assert path.tolist() == [0, 0, 0, 0]


class TestCollections:
    def test_counter(self):
        c = Counter()
        c.increment_count("a", 2.0)
        c.increment_count("b")
        assert c.get_count("a") == 2.0
        assert c.arg_max() == "a"
        assert c.total_count() == 3.0
        c.normalize()
        assert c.get_count("b") == pytest.approx(1 / 3)
        assert c.keys_sorted_by_count() == ["a", "b"]

    def test_counter_map(self):
        cm = CounterMap()
        cm.increment_count("x", "y", 3.0)
        cm.increment_count("x", "z", 1.0)
        assert cm.get_count("x", "y") == 3.0
        assert cm.get_count("missing", "y") == 0.0
        assert cm.total_count() == 4.0

    def test_multidimensional_map(self):
        m = MultiDimensionalMap()
        m.put(1, "a", "v")
        assert m.get(1, "a") == "v"
        assert m.contains(1, "a") and not m.contains(1, "b")
        m.remove(1, "a")
        assert len(m) == 0

    def test_index(self):
        idx = Index()
        assert idx.add("w") == 0
        assert idx.add("w") == 0
        assert idx.add("v") == 1
        assert idx.index_of("v") == 1
        assert idx.index_of("missing") == -1
        assert idx.get(0) == "w"


class TestDiskQueue:
    def test_fifo_roundtrip(self, tmp_path):
        q = DiskBasedQueue(str(tmp_path / "q"))
        for i in range(5):
            q.add({"i": i, "arr": np.arange(3) * i})
        assert len(q) == 5
        assert q.peek()["i"] == 0
        got = [q.poll()["i"] for _ in range(5)]
        assert got == [0, 1, 2, 3, 4]
        assert q.poll() is None and q.is_empty()
        q.close()


class TestSerialization:
    def test_roundtrip(self, tmp_path):
        obj = {"a": np.arange(4), "b": [1, "two"]}
        p = str(tmp_path / "obj.pkl")
        save_object(obj, p)
        back = load_object(p)
        assert back["b"] == [1, "two"]
        assert np.array_equal(back["a"], obj["a"])

    def test_either_package_reads_the_others_file(self, tmp_path):
        from deeplearning4j_tpu.utils import serialization as jax_ser

        obj = {"t": [3, 1, 2], "w": np.float32(0.5)}
        save_object(obj, str(tmp_path / "port.pkl"))
        jax_ser.save_object(obj, str(tmp_path / "jax.pkl"))
        assert jax_ser.load_object(str(tmp_path / "port.pkl")) == obj
        assert load_object(str(tmp_path / "jax.pkl")) == obj
        assert (tmp_path / "port.pkl").read_bytes() == \
            (tmp_path / "jax.pkl").read_bytes()


class TestStringGrid:
    def test_fingerprint_clusters_near_duplicates(self):
        assert fingerprint("The  Quick, Brown!") == fingerprint(
            "brown quick the")
        lines = ["Apple Inc.,1", "apple inc,2", "Banana,3"]
        g = StringGrid.from_lines(lines)
        clusters = g.cluster_column(0)
        assert sorted(map(len, clusters.values())) == [1, 2]
        assert len(g.dedup_by_column(0)) == 2
        assert clusters == jax_sg.StringGrid.from_lines(
            lines).cluster_column(0)

    def test_string_cluster(self):
        strings = ["Apple Inc.", "apple inc", "apple inc", "Banana",
                   "Cherry", "cherry!"]
        c = StringCluster(strings)
        assert len(c) == 3
        assert c.clusters()[0] == {"Apple Inc.": 1, "apple inc": 2}
        assert c.canonical("APPLE, inc") == "apple inc"
        assert c.canonical("unknown thing") == "unknown thing"
        assert c.clusters() == jax_sg.StringCluster(strings).clusters()


class TestTimeSeries:
    def test_moving_window_matrix(self):
        x = np.arange(5)
        w = moving_window_matrix(x, 3)
        assert w.shape == (3, 3)
        assert w[0].tolist() == [0, 1, 2]
        assert w[-1].tolist() == [2, 3, 4]
        w2 = moving_window_matrix(x, 3, add_rotate=True)
        assert w2.shape == (6, 3)
        np.testing.assert_array_equal(
            w2, jax_ts.moving_window_matrix(x, 3, add_rotate=True))

    def test_lagged(self):
        m = lagged(np.array([1, 2, 3, 4]), 2)
        assert m.shape == (2, 3)
        assert m[0].tolist() == [3, 2, 1]
        np.testing.assert_array_equal(
            m, jax_ts.lagged(np.array([1, 2, 3, 4]), 2))

    def test_difference(self):
        assert difference([1, 4, 9]).tolist() == [3, 5]
        assert difference([1, 4, 9, 16], 2).tolist() == \
            jax_ts.difference([1, 4, 9, 16], 2).tolist()

    def test_window_too_large_raises(self):
        with pytest.raises(ValueError):
            moving_window_matrix(np.arange(3), 5)


class TestParallelization:
    def test_run_in_parallel_results_in_order(self):
        from deeplearning4j_tpu_torch.utils.parallelization import (
            iterate_in_parallel, run_in_parallel)

        out = run_in_parallel([lambda i=i: i * i for i in range(20)])
        assert out == [i * i for i in range(20)]
        assert run_in_parallel([]) == []
        assert iterate_in_parallel([3, 1, 2], lambda v: v + 10) == \
            [13, 11, 12]

    def test_exception_propagates(self):
        from deeplearning4j_tpu_torch.utils.parallelization import (
            run_in_parallel)

        def boom():
            raise RuntimeError("task failed")

        with pytest.raises(RuntimeError, match="task failed"):
            run_in_parallel([lambda: 1, boom, lambda: 2])


class TestArchive:
    def test_all_formats_roundtrip(self, tmp_path):
        import gzip
        import tarfile
        import zipfile

        from deeplearning4j_tpu_torch.utils.archive import unzip_file_to

        src = tmp_path / "payload.txt"
        src.write_text("hello archives")

        tgz = tmp_path / "a.tar.gz"
        with tarfile.open(tgz, "w:gz") as t:
            t.add(src, arcname="inner/payload.txt")
        unzip_file_to(str(tgz), str(tmp_path / "out_tgz"))
        assert (tmp_path / "out_tgz/inner/payload.txt").read_text() \
            == "hello archives"

        zf = tmp_path / "a.zip"
        with zipfile.ZipFile(zf, "w") as z:
            z.write(src, "z/payload.txt")
        unzip_file_to(str(zf), str(tmp_path / "out_zip"))
        assert (tmp_path / "out_zip/z/payload.txt").exists()

        gz = tmp_path / "solo.txt.gz"
        with gzip.open(gz, "wb") as g:
            g.write(b"gz body")
        unzip_file_to(str(gz), str(tmp_path / "out_gz"))
        assert (tmp_path / "out_gz/solo.txt").read_bytes() == b"gz body"

        with pytest.raises(ValueError, match="unsupported"):
            unzip_file_to(str(src), str(tmp_path / "nope"))


# -- profiling (tests/test_profiling.py) --------------------------------------

def test_step_timer_summary():
    t = StepTimer("job")
    for _ in range(5):
        with t:
            time.sleep(0.002)
    s = t.summary()
    assert s["count"] == 5
    assert s["mean_ms"] >= 1.0
    assert s["min_ms"] <= s["p50_ms"] <= s["max_ms"]
    assert StepTimer().summary() == {"count": 0}


def test_throughput_meter_blocks_on_device():
    m = ThroughputMeter()
    x = torch.ones((64, 64))
    with m.measure(128) as meas:
        y = meas.block(x @ x)  # created inside the block, synced before stop
    assert m.samples == 128
    assert m.samples_per_sec > 0
    assert y.shape == (64, 64)


def test_throughput_meter_synchronizes_each_cuda_device_once(monkeypatch):
    """CUDA results wait on their device (`torch.cuda.synchronize`), once
    a device however many results lie there; CPU tensors and other values
    wait on nothing."""
    from deeplearning4j_tpu_torch.utils import profiling

    class FakeCuda:
        is_cuda = True
        device = torch.device("cuda", 1)

    synced = []
    monkeypatch.setattr(torch, "Tensor", FakeCuda)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    profiling._sync_devices([FakeCuda(), (FakeCuda(), "x"), 3])
    assert synced == [torch.device("cuda", 1)]


def test_metrics_registry_report():
    r = MetricsRegistry()
    r.increment("jobs")
    r.increment("jobs", 2)
    r.gauge("loss", 0.5)
    rep = r.report()
    assert rep["jobs"] == 3.0
    assert rep["loss"] == 0.5
    assert isinstance(METRICS, MetricsRegistry)


def test_timing_listener_accumulates():
    r = MetricsRegistry()
    lst = TimingIterationListener(r)
    for i in range(3):
        lst.iteration_done(None, i, 1.0 - 0.1 * i)
    rep = r.report()
    assert rep["iterations"] == 3.0
    assert rep["last_score"] == 0.8
    assert rep["iteration_ms_total"] >= 0.0


def test_tracer_annotation_usable():
    with Tracer.annotate("test-region"):
        _ = torch.sum(torch.arange(10))


def test_tracer_on_the_cpu_writes_a_trace_naming_the_span(tmp_path):
    tracer = Tracer(str(tmp_path / "trace"), device="cpu")
    with tracer.trace():
        with Tracer.annotate("port-span"):
            torch.ones((32, 32)) @ torch.ones((32, 32))
    assert tracer.trace_path == str(tmp_path / "trace" / "trace.json")
    with open(tracer.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "port-span" in names
    assert any(str(n).startswith("aten::mm") for n in names)
    # start/stop pair up; a second stop is a no-op
    tracer.stop()


def test_tracer_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tracer(str(tmp_path))
    default = Tracer(device="cpu")
    assert os.path.basename(default.trace_dir) == "dl4j_tpu_torch_trace"

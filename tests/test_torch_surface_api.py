"""The names the surface test found missing, ported, against the JAX
package (on the CPU).

The nine batch-mean losses equal JAX's within 1e-6 relative and refuse
sparse labels where `get_loss` does; `MultiLayerConfiguration.override`
gives JAX's `to_json`; `OutputLayer.score`, `MultiLayerNetwork.f1_score`
and `evaluate(..., evaluation=)` give JAX's F1 and counts on weights
carried over from JAX; `Solver.optimize` is `optimize` bitwise and JAX's at
`tests/test_torch_solvers.py`'s tolerance; `rows_broadcast` is JAX's
exactly; `CircuitBreaker.state_code` and the caches' fixed `buckets` are
JAX's. `program_memory` under a 1 x 2 gloo plan
(`tests/torch_surface_worker.py`) counts fewer bytes a rank than the
replicated layout, as `tests/test_tp_mesh.py` asserts of JAX's, and the
ranks' `save_sharded_async` checkpoint loads back bitwise in both
packages; `clear` leaves no program and fresh books. The prefetcher's
`pull` hands each batch to exactly one of four consumer threads (and of
twice as many as there are cores, switching threads every microsecond),
a `close` from another thread ends a waiting consumer, and an armed
`prefetch.worker` fault reaches exactly one consumer.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet  # noqa: E402,E501
from deeplearning4j_tpu.evaluation import evaluate as jax_evaluate  # noqa: E402,E501
from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nd import losses as jax_losses  # noqa: E402
from deeplearning4j_tpu.nn import conf as jc  # noqa: E402
from deeplearning4j_tpu.nn.layers import base as jax_base  # noqa: E402
from deeplearning4j_tpu.nn.layers.output import OutputLayer as JaxOutput  # noqa: E402,E501
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet  # noqa: E402,E501
from deeplearning4j_tpu.optimize import solver as jax_solver  # noqa: E402
from deeplearning4j_tpu.optimize.step_cache import \
    CompiledProgramCache as JaxCache  # noqa: E402
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu.parallel.plan import plan_mesh as jax_plan_mesh  # noqa: E402,E501
from deeplearning4j_tpu.reliability.circuit import \
    CircuitBreaker as JaxBreaker  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterator import PrefetchIterator  # noqa: E402,E501
from deeplearning4j_tpu_torch.evaluation import Evaluation, evaluate  # noqa: E402,E501
from deeplearning4j_tpu_torch.nd import losses, platform  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as tc  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import base  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import Solver, solver  # noqa: E402
from deeplearning4j_tpu_torch.optimize.step_cache import (  # noqa: E402
    CompiledProgramCache, TrainStepCache)
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402
from deeplearning4j_tpu_torch.reliability.circuit import CircuitBreaker  # noqa: E402,E501

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_surface_worker.py")
LOSSES = ["mcxent", "xent", "mse", "expll", "rmse_xent", "squared_loss",
          "negativeloglikelihood", "reconstruction_crossentropy",
          "cosine_proximity"]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


# -- losses ------------------------------------------------------------------

@pytest.mark.parametrize("name", LOSSES)
def test_batch_mean_losses_are_jaxs(name):
    rng = np.random.RandomState(7)
    out = rng.dirichlet(np.ones(5), size=16).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 16)]
    want = float(getattr(jax_losses, name)(jnp.asarray(labels),
                                           jnp.asarray(out)))
    fn = getattr(losses, name)
    got = float(fn(torch.from_numpy(labels), torch.from_numpy(out)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert fn is losses.get_loss(name)
    ids = torch.from_numpy(labels.argmax(-1).astype(np.int64))
    if name in ("mcxent", "negativeloglikelihood"):
        sparse = float(fn(ids, torch.from_numpy(out)))
        np.testing.assert_allclose(sparse, got, rtol=1e-6)
    else:
        with pytest.raises(TypeError, match="sparse"):
            fn(ids, torch.from_numpy(out))
        with pytest.raises(TypeError, match="sparse"):
            jax_losses.get_loss(name)(jnp.asarray(ids.numpy()),
                                      jnp.asarray(out))


# -- confs, output layer, network -------------------------------------------

def _mlp(m):
    base_conf = m.NeuralNetConfiguration(activation="tanh", lr=0.1, seed=3)
    return (m.list_builder(base_conf, 2)
            .hidden_layer_sizes([6], n_in=4, n_out=3)
            .override(1, layer_type=m.LayerType.OUTPUT).build())


def test_conf_override_gives_jaxs_json():
    jconf, tconf = _mlp(jc), _mlp(tc)
    for i, kw in ((0, dict(n_out=9, activation="relu")),
                  (1, dict(loss_function="mse", lr=0.5))):
        want = jconf.override(i, **kw)
        got = tconf.override(i, **kw)
        assert got.to_json() == want.to_json()
        assert got is not tconf and tconf.to_json() == jconf.to_json()


def _nets():
    jconf = _mlp(jc)
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(tc.MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu")
    net.params = checkpoint.params_from_numpy(
        jax.device_get(jnet.params), "cpu")
    rng = np.random.RandomState(11)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 40)]
    return jnet, net, x, y


def test_output_layer_score_and_f1_score_are_jaxs():
    jnet, net, x, y = _nets()
    h = np.random.RandomState(2).standard_normal((40, 6)).astype(np.float32)
    want = JaxOutput.score(jnet.params[1], jnet.conf.confs[1],
                           jnp.asarray(h), jnp.asarray(y))
    got = OutputLayer.score(net.params[1], net.conf.confs[1],
                            torch.from_numpy(h), torch.from_numpy(y))
    assert got == pytest.approx(want, rel=1e-12) and 0.0 < got < 1.0
    assert OutputLayer.score(net.params[1], net.conf.confs[1], h, y) == got
    assert net.f1_score(x, y) == pytest.approx(jnet.f1_score(x, y),
                                               rel=1e-12)


def test_evaluate_into_an_evaluation_equals_one_pass():
    jnet, net, x, y = _nets()
    whole = evaluate(net, DataSet(x, y), prefetch=False)
    ev = Evaluation()
    for sl in (slice(0, 17), slice(17, 40)):
        got = evaluate(net, DataSet(x[sl], y[sl]), evaluation=ev)
        assert got is ev
    jev = jax_evaluate(jnet, JaxDataSet(x[:17], y[:17]))
    jax_evaluate(jnet, JaxDataSet(x[17:], y[17:]), evaluation=jev)
    for e in (ev, jev):
        assert e.confusion.total() == whole.confusion.total() == 40
        assert e.accuracy() == whole.accuracy()
        assert e.f1() == pytest.approx(whole.f1(), rel=1e-12)
    assert net.f1_score(x, y) == pytest.approx(whole.f1(), rel=1e-12)


# -- the solver facade -------------------------------------------------------

_A = np.diag([1.0, 10.0, 100.0]).astype(np.float32)
_B = np.array([1.0, -2.0, 3.0], np.float32)


def _jax_quad(params, key=None):
    x = params["x"]
    return 0.5 * x @ jnp.asarray(_A) @ x - jnp.asarray(_B) @ x


def _quad(params, key=None):
    x = params["x"]
    return 0.5 * x @ torch.from_numpy(_A) @ x - torch.from_numpy(_B) @ x


@pytest.mark.parametrize("algo", ["gradient_descent", "conjugate_gradient",
                                  "lbfgs", "iteration_gradient_descent"])
def test_solver_facade_is_optimize_and_jaxs(algo):
    kw = dict(optimization_algo=algo, num_iterations=5, lr=0.009)
    jconf, tconf = jc.NeuralNetConfiguration(**kw), \
        tc.NeuralNetConfiguration(**kw)
    key = jax.random.PRNGKey(0)
    tkey = nd_random.key_array(np.asarray(key))
    p0 = np.array([5.0, 5.0, 5.0], np.float32)
    obj = solver.from_loss(_quad)
    got_p, got_s = Solver(tconf, obj).optimize({"x": torch.from_numpy(p0)},
                                               tkey)
    ref_p, ref_s = solver.optimize(obj, {"x": torch.from_numpy(p0)}, tconf,
                                   tkey)
    assert torch.equal(got_p["x"], ref_p["x"])
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(ref_s))
    jp, js = jax_solver.Solver(jconf, jax_solver.from_loss(_jax_quad)) \
        .optimize({"x": jnp.asarray(p0)}, key)
    js = np.asarray(js)
    np.testing.assert_allclose(np.asarray(got_s), js, rtol=0,
                               atol=1e-5 * np.abs(js).max())
    np.testing.assert_allclose(got_p["x"].numpy(), np.asarray(jp["x"]),
                               rtol=1e-5, atol=1e-5)


# -- small helpers -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, "bfloat16", "float32"])
def test_rows_broadcast_is_jaxs(dtype):
    v = np.random.RandomState(4).standard_normal(7).astype(np.float32)
    want = np.asarray(jax_base.rows_broadcast(
        jnp.asarray(v), 5, None if dtype is None else jnp.dtype(dtype)))
    got = base.rows_broadcast(torch.from_numpy(v), 5, dtype)
    assert tuple(got.shape) == want.shape == (5, 7)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    assert base.rows_broadcast(torch.from_numpy(v), 5,
                               torch.bfloat16).dtype == torch.bfloat16


def test_state_code_follows_the_state_as_jax():
    now = [0.0]
    breakers = [cls(failure_threshold=2, reset_timeout_s=5.0,
                    clock=lambda: now[0]) for cls in (CircuitBreaker,
                                                      JaxBreaker)]
    seen = []
    for step in ("start", "fail", "fail", "wait"):
        if step == "fail":
            for b in breakers:
                b.record_failure()
        if step == "wait":
            now[0] += 6.0
        seen.append([(b.state, b.state_code) for b in breakers])
    assert [s[0] for s in seen] == [s[1] for s in seen]
    assert [s[0] for s in seen] == [("closed", 0), ("closed", 0),
                                    ("open", 1), ("half_open", 2)]
    for state, code in CircuitBreaker.STATE_CODES.items():
        assert JaxBreaker.STATE_CODES[state] == code


def test_fixed_buckets_and_persist_are_jaxs():
    store = object()
    for buckets in (None, (4, 8), ()):
        ours, theirs = (CompiledProgramCache(buckets=buckets),
                        JaxCache(buckets=buckets))
        got = [ours.bucket_rows(n) for n in (3, 8, 9, 5, 12)]
        want = [theirs.bucket_rows(n) for n in (3, 8, 9, 5, 12)]
        assert got == want and ours.buckets == theirs.buckets
    assert TrainStepCache(persist=store).persist is store


def test_devices_lists_the_cuda_devices(monkeypatch):
    monkeypatch.setattr(platform, "cuda_available", lambda: False)
    assert platform.devices() == ()
    monkeypatch.setattr(platform, "cuda_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert platform.devices() == (torch.device("cuda", 0),
                                  torch.device("cuda", 1))


# -- program_memory, clear and the sharded async checkpoint at 1 x 2 ---------

VOCAB = 32


def _tf():
    return jax_zoo.char_transformer(VOCAB, d_model=16, n_blocks=2, n_heads=2,
                                    max_seq_len=32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, compute JAX's side while they work."""
    work = tmp_path_factory.mktemp("surface_ranks")
    conf = _tf()
    params = jax.device_get(JaxNet(conf, seed=0).init().params)
    x = np.random.RandomState(0).randint(1, VOCAB, (8, 16)).astype(np.int32)
    np.savez(work / "inputs.npz", x=x,
             **{f"params/{i}/{k}": np.asarray(a)
                for i, layer in enumerate(params) for k, a in layer.items()})
    (work / "conf.json").write_text(conf.to_json())
    env = dict(os.environ, WORLD_SIZE="2", OMP_NUM_THREADS="1",
               HOME=str(work))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(work)],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=str(work))
             for r in range(2)]
    jnet = JaxNet(conf, seed=0).init()
    jnet.set_serve_mesh(mesh=jax_plan_mesh({"batch": 1, "model": 2},
                                           devices=jax.devices()[:2]))
    jnet.infer_cache.output(conf, jnet.params, x, compile_only=True)
    want = [r for r in jnet.infer_cache.program_memory()
            if r["entry"] == "output"]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    with open(work / "out.json") as f:
        got = json.load(f)
    return {"got": got, "want": want, "params": params, "conf": conf,
            "ckpt": str(work / "ckpt")}


def test_program_memory_counts_fewer_bytes_a_rank_under_a_model_axis(ranks):
    rows = [r for r in ranks["got"]["rows"] if r["entry"] == "output"]
    assert rows and ranks["want"]
    for r in rows:
        assert set(r) == set(ranks["want"][0])
        assert r["per_device_argument_bytes"] < \
            r["replicated_argument_bytes"]
        # on the CPU no program is captured
        assert r["memory_analysis"] is None
    # the whole layout is JAX's argument bytes, params and rows alike
    assert rows[0]["replicated_argument_bytes"] == \
        ranks["want"][0]["replicated_argument_bytes"]
    assert ranks["got"]["imports"] == []


def test_clear_leaves_no_program_and_fresh_books(ranks):
    assert ranks["got"]["programs_before_clear"] > 0
    assert ranks["got"]["programs_after_clear"] == 0
    assert ranks["got"]["rows_after_clear"] == 0
    net = MultiLayerNetwork(tc.MultiLayerConfiguration.from_json(
        ranks["conf"].to_json()), device="cpu", seed=0).init()
    net.output(np.ones((2, 8), np.int32))
    ic = net.infer_cache
    assert len(ic) and ic.stats.misses and ic.buckets
    ic.clear()
    assert len(ic) == 0 and ic.program_memory() == []
    assert ic.stats.as_dict() == type(ic.stats)().as_dict()
    assert ic.buckets == ()


def test_the_ranks_sharded_async_checkpoint_loads_back_bitwise(ranks):
    whole = checkpoint.params_from_numpy(ranks["params"], "cpu")
    got, _, meta = checkpoint.load_sharded(ranks["ckpt"], like_params=whole)
    assert meta["step"] == 3 and meta["layout"] == "sharded"
    for a, b in zip(got, whole):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    jgot, _, _ = jax_checkpoint.load_sharded(ranks["ckpt"],
                                             like_params=ranks["params"])
    for a, b in zip(jax.device_get(jgot), ranks["params"]):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])


def test_save_sharded_async_equals_save_sharded_and_raises_at_join(tmp_path):
    rng = np.random.RandomState(5)
    params = ({"W": torch.from_numpy(rng.standard_normal((3, 4))
                                     .astype(np.float32)),
               "b": torch.zeros(4)},)
    before = params[0]["W"].clone()
    checkpoint.save_sharded(str(tmp_path / "sync"), params, step=2)
    checkpoint.save_sharded_async(str(tmp_path / "async"), params, step=2)
    params[0]["W"].add_(1.0)  # the host copies were taken at the call
    checkpoint.join_async()
    a, _, ma = checkpoint.load_sharded(str(tmp_path / "sync"),
                                       like_params=params)
    b, _, mb = checkpoint.load_sharded(str(tmp_path / "async"),
                                       like_params=params)
    assert ma == mb
    assert torch.equal(a[0]["W"], b[0]["W"])
    assert torch.equal(b[0]["W"], before)
    faults.arm("checkpoint.save", nth=1)
    checkpoint.save_sharded_async(str(tmp_path / "fails"), params)
    with pytest.raises(faults.FaultInjected):
        checkpoint.join_async()
    # one hit a save: the sync one, the async one, the failed one
    assert faults.hits("checkpoint.save") == 3
    assert not (tmp_path / "fails").exists()
    checkpoint.join_async()  # raised once


# -- the prefetcher's multi-consumer pull ------------------------------------

def _items(n, rows=2):
    return [(np.full((rows, 3), i, np.float32),
             np.full((rows, 1), i, np.float32)) for i in range(n)]


def _consumers(it, n):
    got, outcomes, lock = [], [], threading.Lock()

    def consume():
        served = 0
        try:
            while True:
                feats, _ = it.pull()
                with lock:
                    got.append(int(feats[0, 0]))
                served += 1
        except StopIteration:
            with lock:
                outcomes.append(("stop", served))
        except faults.FaultInjected:
            with lock:
                outcomes.append(("fault", served))

    threads = [threading.Thread(target=consume) for _ in range(n)]
    for t in threads:
        t.start()
    return threads, got, outcomes


@pytest.mark.parametrize("to_device", [True, False])
def test_pull_hands_each_batch_to_exactly_one_of_four_consumers(to_device):
    it = PrefetchIterator(_items(40), device="cpu", buffer_batches=2,
                          to_device=to_device)
    it.start()
    threads, got, outcomes = _consumers(it, 4)
    for t in threads:
        t.join(timeout=20.0)
        assert not t.is_alive(), "a consumer did not end"
    assert sorted(got) == list(range(40))
    assert sorted(k for k, _ in outcomes) == ["stop"] * 4
    it.close()


def test_pull_under_thread_churn_delivers_each_batch_once():
    # more consumers than cores, switching threads as often as it can:
    # a lost or doubled batch breaks the exactly-once invariant
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        it = PrefetchIterator(_items(300, rows=1), device="cpu",
                              buffer_batches=3)
        it.start()
        n = 2 * (os.cpu_count() or 4)
        threads, got, outcomes = _consumers(it, n)
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "a consumer did not end"
        it.close()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(got) == list(range(300))
    assert sorted(k for k, _ in outcomes) == ["stop"] * n


def test_close_from_another_thread_ends_a_waiting_consumer():
    stall = threading.Event()

    def slow():
        yield (np.zeros((1, 2), np.float32), np.zeros((1, 1), np.float32))
        stall.wait(timeout=30.0)

    it = PrefetchIterator(slow(), device="cpu")
    first = it.pull()
    assert isinstance(first[0], torch.Tensor)
    threads, got, outcomes = _consumers(it, 2)
    time.sleep(0.2)
    assert not got and all(t.is_alive() for t in threads)
    it.close(join_timeout=0.2)
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive(), "close() left a consumer waiting"
    assert sorted(outcomes) == [("stop", 0), ("stop", 0)]
    stall.set()


def test_a_worker_fault_reaches_exactly_one_consumer():
    faults.arm("prefetch.worker", nth=4)
    it = PrefetchIterator(_items(6), device="cpu")
    it.start()
    threads, got, outcomes = _consumers(it, 4)
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive(), "a worker fault left a consumer waiting"
    it.close()
    assert sorted(k for k, _ in outcomes) == ["fault", "stop", "stop",
                                              "stop"]
    assert sorted(got) == [0, 1, 2]  # the batches before the fault
    assert faults.hits("prefetch.worker") == 4

"""The port's repairs that the linter over its tree asked for, on the CPU.

- The micro-batcher fires `dispatcher.execute` (with `rows=`) before its
  primary device call, where the JAX package's does, so a fault plan
  armed on it reaches the port: the counterpart of the JAX package's chaos
  test (tests/test_reliability.py) opens the breaker, the degraded path
  answers every request with the eager output, and the breaker closes
  again; an open breaker never traverses the point.
- The card queries go through `nd/platform.py`.
- A conf's "float64" dtype computes in float32, as the JAX package does
  with x64 disabled.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu_torch.nd import platform  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork, network_output)
from deeplearning4j_tpu_torch.parallel.checkpoint import (  # noqa: E402
    params_from_numpy)
from deeplearning4j_tpu_torch.reliability import CircuitBreaker  # noqa: E402
from deeplearning4j_tpu_torch.reliability import faults  # noqa: E402
from deeplearning4j_tpu_torch.serving import MicroBatcher  # noqa: E402

N_IN, N_OUT = 6, 3


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def pair():
    """(JAX network, port network on the CPU) with JAX's params."""
    jconf = jax_zoo.mlp(n_in=N_IN, hidden=[8], n_out=N_OUT, lr=0.05)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu")
    net.params = params_from_numpy(jax.device_get(jnet.params), "cpu")
    return jnet, net


def _x(rows, seed):
    return np.random.RandomState(seed).randn(rows, N_IN).astype(np.float32)


def _eager(net, x):
    with torch.inference_mode():
        return network_output(net.conf, net.params,
                              torch.as_tensor(x)).numpy()


def test_chaos_serve_breaker_opens_degrades_and_recovers(pair):
    """32 closed-loop clients while `dispatcher.execute` raises on the
    primary path's executions 2..7: every response is the right
    activations (the degraded eager path's or the cached path's, each
    within float32 rounding of JAX's), no client hangs, the breaker
    opens, and once the faults stop it closes again."""
    jnet, net = pair
    net.warmup([32])
    breaker = CircuitBreaker(failure_threshold=3, reset_timeout_s=0.05,
                             probe_prob=1.0)
    batcher = MicroBatcher(net, max_delay_ms=2.0, breaker=breaker)
    clients = 32
    xs = [_x(1 + i % 3, seed=i) for i in range(clients)]
    direct = [net.output(x).numpy() for x in xs]
    for x, d in zip(xs, direct):
        np.testing.assert_array_equal(d, _eager(net, x))
        np.testing.assert_allclose(d, np.asarray(jnet.output(x)),
                                   rtol=1e-5, atol=1e-6)
    faults.arm("dispatcher.execute", "raise", nth=2, times=6)
    wrong, errors, lock = [], [], threading.Lock()

    def client(i):
        for _ in range(6):
            try:
                got = batcher.predict(xs[i], timeout=30.0)
                # a coalesced batch runs a GEMM of another row count than
                # the request alone, which may move the last bits (the
                # reference's bitwise version of this test is flaky)
                if not np.allclose(direct[i], got, rtol=1e-5, atol=1e-6):
                    with lock:
                        wrong.append(i)
            except Exception as e:  # noqa: BLE001 — checked below
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive(), "chaos client hung"
    assert not wrong, f"degraded/primary responses diverged: {wrong}"
    # the fault raises BEFORE the device call, so every faulted batch
    # falls back to the degraded path and still answers
    assert not errors, errors[:3]
    assert faults.hits("dispatcher.execute") >= 4  # three raised, at least

    deadline = time.monotonic() + 20.0
    while breaker.state != CircuitBreaker.CLOSED and \
            time.monotonic() < deadline:
        time.sleep(0.06)
        batcher.predict(xs[0], timeout=30.0)
    st = batcher.stats()
    batcher.stop()
    assert st["breaker"]["state"] == CircuitBreaker.CLOSED
    assert st["breaker"]["opens"] >= 1, st["breaker"]
    assert st["degraded_batches"] >= 1, st
    assert st["degraded"] is False


def test_open_breaker_never_traverses_the_point(pair):
    _, net = pair
    x = _x(5, seed=11)
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=600.0)
    br.record_failure()
    assert br.state == CircuitBreaker.OPEN
    batcher = MicroBatcher(net, max_delay_ms=2.0, breaker=br)
    got = batcher.predict(x, timeout=30.0)
    st = batcher.stats()
    batcher.stop()
    np.testing.assert_array_equal(got, _eager(net, x))
    assert st["degraded_batches"] == 1 and st["degraded"] is True
    assert faults.hits("dispatcher.execute") == 0  # primary never ran


def test_point_fires_once_a_batch_with_its_rows(pair, monkeypatch):
    _, net = pair
    seen = []
    fire = faults.REGISTRY.fire

    def spy(point, data=None, **ctx):
        if point == "dispatcher.execute":
            seen.append(ctx)
        return fire(point, data, **ctx)

    monkeypatch.setattr(faults.REGISTRY, "fire", spy)
    monkeypatch.setattr(faults, "fire", spy)
    batcher = MicroBatcher(net, max_delay_ms=2.0)
    batcher.predict(_x(3, seed=1), timeout=30.0)
    batcher.stop()
    assert seen == [{"rows": 3}]
    assert faults.hits("dispatcher.execute") == 1


def test_env_plan_delay_holds_the_primary_call(pair):
    """`DL4J_FAULT_PLAN="dispatcher.execute=delay:..."` (the metrics
    test's straggler) now holds a batch in flight."""
    _, net = pair
    assert faults.install_env_plan("dispatcher.execute=delay:0.3") == 1
    batcher = MicroBatcher(net, max_delay_ms=1.0)
    t0 = time.monotonic()
    batcher.predict(_x(2, seed=2), timeout=30.0)
    held = time.monotonic() - t0
    batcher.stop()
    assert held >= 0.3


def test_card_queries_go_through_platform(monkeypatch):
    from deeplearning4j_tpu_torch.optimize.persist import platform_info

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert platform.cuda_available() is False
    assert platform.device_count() == 0
    assert platform.device_capability(torch.device("cpu")) is None
    info = platform_info()
    assert (info["backend"], info["device_kind"], info["capability"],
            info["n_devices"]) == ("cpu", "cpu", None, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert platform.cuda_available() and platform.device_count() == 3


def test_float64_conf_dtype_computes_in_float32_as_jax():
    jconf = jax_zoo.mlp(n_in=N_IN, hidden=[4], n_out=N_OUT)
    jconf = jconf.replace(confs=tuple(c.replace(dtype="float64")
                                      for c in jconf.confs))
    jparams = jax.device_get(jax_ml.MultiLayerNetwork(jconf, seed=0)
                             .init().params)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", seed=0).init()
    for jl, tl in zip(jparams, net.params):
        for k in jl:
            assert np.asarray(jl[k]).dtype == np.float32
            assert tl[k].dtype == torch.float32
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    x = _x(4, seed=3).astype(np.float64)
    assert net.output(x).dtype == torch.float32

"""The parameter-server protocol cases of tests/test_param_server.py on
the port's copy (`deeplearning4j_tpu_torch/scaleout/param_server.py`),
each run with the three pairings of the packages: the port's server and
client, JAX's client against the port's server, and the port's client
against JAX's server. The wire format (npz `vec` bodies, routes, status
codes) is one, so every pairing gives the same exact answers.
"""

import threading
import time
import urllib.error

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.scaleout import param_server as jax_ps  # noqa: E402
from deeplearning4j_tpu_torch.scaleout import param_server as port_ps  # noqa: E402,E501

#: (server module, client module) pairings
PAIRS = {"port-port": (port_ps, port_ps), "jax-client": (port_ps, jax_ps),
         "jax-server": (jax_ps, port_ps)}


@pytest.fixture(params=sorted(PAIRS))
def pair(request):
    return PAIRS[request.param]


def _serve(pair, mode="bsp"):
    server_mod, client_mod = pair
    ps = server_mod.ParameterServer(np.zeros(4, np.float32), n_workers=2,
                                    iterations=3, mode=mode)
    url = f"http://127.0.0.1:{ps.serve(0)}"

    def client(name, **kw):
        return client_mod.ParameterServerWorker(url, name, **kw)
    return ps, client


@pytest.fixture
def server(pair):
    ps, client = _serve(pair)
    yield ps, client
    ps.shutdown()


@pytest.fixture
def async_server(pair):
    ps, client = _serve(pair, mode="async")
    yield ps, client
    ps.shutdown()


def test_startup_assigns_splits(server):
    ps, client = server
    a = client("wA").startup()
    b = client("wB").startup()
    assert {a["split_index"], b["split_index"]} == {0, 1}
    assert a["total_splits"] == 2 and a["iterations"] == 3


def test_update_round_gates_until_all_workers(server):
    ps, client = server
    wa, wb = client("wA"), client("wB")
    wa.startup(), wb.startup()
    assert wa.update(np.full(4, 2.0, np.float32))["round"] == 0
    assert wa.waiting()["banked"] == 1
    assert wb.update(np.full(4, 4.0, np.float32))["round"] == 1
    np.testing.assert_array_equal(wa.fetch(1), np.full(4, 3.0))


def test_fetch_polls_until_published(server):
    ps, client = server
    wa = client("wA", poll_interval_s=0.01)
    wb = client("wB")
    wa.startup(), wb.startup()

    def late_update():
        time.sleep(0.1)
        wa.update(np.ones(4, np.float32))
        wb.update(np.ones(4, np.float32))

    t = threading.Thread(target=late_update)
    t.start()
    got = wa.fetch(1)  # blocks (409-poll) until the round lands
    t.join()
    np.testing.assert_array_equal(got, 1.0)


def test_multi_round_bsp_training_loop(server):
    """Two workers do 3 BSP rounds of 'local training' (+1 / +3)."""
    ps, client = server
    out = {}

    def work(name, delta):
        w = client(name, poll_interval_s=0.01)
        w.startup()
        vec = np.zeros(4, np.float32)
        for r in range(1, 4):
            w.update(vec + delta)
            vec = w.fetch(r)
            w.progress(round=r)
        w.metrics_report({"steps": 3})
        w.complete()
        out[name] = vec

    ts = [threading.Thread(target=work, args=(n, d))
          for n, d in (("wA", 1.0), ("wB", 3.0))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    np.testing.assert_array_equal(out["wA"], 6.0)
    np.testing.assert_array_equal(out["wB"], 6.0)
    assert ps.metrics["steps"] == 6.0
    assert ps.completed == {"wA", "wB"}
    assert set(ps.progress) == {"wA", "wB"}


def test_error_reporting(server):
    ps, client = server
    w = client("wX")
    w.startup()
    w.error("container lost")
    assert ps.errors["wX"] == "container lost"


def test_async_update_applies_immediately(async_server):
    ps, client = async_server
    w0 = client("w0")
    assert w0.startup()["mode"] == "async"
    w0.update_delta(np.ones(4, np.float32))
    assert ps.round == 1
    np.testing.assert_array_equal(w0.fetch(0), np.ones(4))
    np.testing.assert_array_equal(w0.fetch(999), np.ones(4))  # never gated
    w0.update_delta(2 * np.ones(4, np.float32))
    np.testing.assert_array_equal(w0.fetch(0), 3 * np.ones(4))


def test_async_straggler_does_not_gate(async_server):
    ps, client = async_server
    fast, slow = client("fast"), client("slow")
    fast.startup(), slow.startup()

    def slow_loop():
        time.sleep(0.5)
        slow.update_delta(np.ones(4, np.float32))

    t = threading.Thread(target=slow_loop)
    t.start()
    for _ in range(10):  # all land before the slow worker's single one
        fast.update_delta(0.1 * np.ones(4, np.float32))
    assert ps.round >= 10
    t.join()
    np.testing.assert_allclose(np.asarray(ps.fetch(0)), 2.0 * np.ones(4),
                               rtol=1e-6)


def test_bsp_rejects_delta_updates(server):
    ps, client = server
    w = client("w0")
    w.startup()
    with pytest.raises(urllib.error.HTTPError):
        w.update_delta(np.ones(4, np.float32))


def test_async_rejects_full_vector_updates(async_server):
    ps, client = async_server
    w = client("w0")
    w.startup()
    w.update_delta(np.ones(4, np.float32))
    with pytest.raises(urllib.error.HTTPError):
        w.update(5 * np.ones(4, np.float32))  # default kind="vec"
    np.testing.assert_array_equal(np.asarray(ps.fetch(0)), np.ones(4))

"""The port's micro-batcher and HTTP server on the CPU vs the JAX package.

Every request, coalesced with others into one device call, must get the
rows of its own answer: the JAX package's `network_output` on that request
alone. The charTransformer returns S rows per input row, which is where the
JAX package's batcher slices wrongly; the port slices by the output rows
per input row.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.parallel.checkpoint import (  # noqa: E402
    params_from_numpy)
from deeplearning4j_tpu_torch.reliability import (  # noqa: E402
    CircuitBreaker, DeadlineExceeded)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    MicroBatcher, ServerDraining, ServerOverloaded)

VOCAB, SEQ = 24, 8


@pytest.fixture(scope="module")
def nets():
    """(JAX conf, JAX params, port network on the CPU) sharing weights.
    The port runs its flash path; the JAX reference runs dense attention
    (test_torch_layers.py holds the two flash paths together), which keeps
    the per-request references quick."""
    jconf = jax_zoo.char_transformer(VOCAB, d_model=16, n_blocks=1,
                                     n_heads=2, max_seq_len=16)
    jparams = jax.device_get(jax_ml.init_params(jconf,
                                                jax.random.PRNGKey(0)))
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    net = MultiLayerNetwork(tconf.replace(confs=tuple(
        c.replace(attention_impl="flash") for c in tconf.confs)),
        device="cpu")
    net.params = params_from_numpy(jparams, "cpu")
    return jconf, jparams, net


def _requests(rows=(1, 2, 3), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (r, SEQ)) for r in rows]


def _jax_answer(nets, x):
    jconf, jparams, _ = nets
    fn = jax.jit(jax_ml.network_output, static_argnums=0)
    return np.asarray(fn(jconf, jax.tree_util.tree_map(jnp.asarray, jparams),
                         jnp.asarray(x)))


def _submit_all(batcher, xs, **kw):
    """Queue every request from its own thread before the dispatcher
    starts, so they coalesce into one flush; returns results and errors."""
    results, errors = [None] * len(xs), [None] * len(xs)

    def call(i):
        try:
            results[i] = batcher.predict(xs[i], timeout=30, **kw)
        except Exception as e:  # noqa: BLE001 — checked by the caller
            errors[i] = e

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while batcher.queue_depth() < len(xs) and time.monotonic() < deadline:
        time.sleep(0.005)
    batcher.start()
    for t in threads:
        t.join(30)
    batcher.stop()
    return results, errors


def test_coalesced_requests_each_get_their_own_rows(nets):
    xs = _requests()
    batcher = MicroBatcher(nets[2], max_delay_ms=1000, auto_start=False)
    results, errors = _submit_all(batcher, xs)
    assert errors == [None, None, None]
    assert batcher.stats()["batch_rows_hist"] == {"6": 1}
    for x, got in zip(xs, results):
        assert got.shape == (x.shape[0] * SEQ, VOCAB)
        np.testing.assert_allclose(got, _jax_answer(nets, x), rtol=1e-4,
                                   atol=1e-4)


def test_flush_splits_at_max_batch_rows(nets):
    xs = _requests(rows=(2, 2, 2), seed=1)
    batcher = MicroBatcher(nets[2], max_delay_ms=1000, max_batch_rows=4,
                           auto_start=False)
    results, errors = _submit_all(batcher, xs)
    assert errors == [None, None, None]
    assert batcher.stats()["batch_rows_hist"] == {"2": 1, "4": 1}
    for x, got in zip(xs, results):
        np.testing.assert_allclose(got, _jax_answer(nets, x), rtol=1e-4,
                                   atol=1e-4)


def test_open_breaker_serves_the_eager_path_on_the_same_device(nets,
                                                               monkeypatch):
    jconf, jparams, net = nets
    breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=60.0)
    batcher = MicroBatcher(net, max_delay_ms=1000, auto_start=False,
                           breaker=breaker)

    def broken(x):
        raise RuntimeError("primary path down")

    monkeypatch.setattr(batcher, "_primary_output", broken)
    xs = _requests(rows=(1, 2), seed=2)
    results, errors = _submit_all(batcher, xs)
    assert errors == [None, None]
    stats = batcher.stats()
    assert stats["degraded_batches"] == 1 and stats["degraded"]
    for x, got in zip(xs, results):
        np.testing.assert_allclose(got, _jax_answer(nets, x), rtol=1e-4,
                                   atol=1e-4)


def test_open_breaker_answers_eagerly_within_bf16_and_counts_degraded(nets):
    # the primary path replays the infer cache's program; with the breaker
    # open the server answers through the eager forward instead, which
    # never touches the cache, within bf16 of net.output
    jconf, jparams, _ = nets
    tconf = MultiLayerConfiguration.from_json(
        jconf.to_json()).with_compute_dtype("bfloat16")
    net = MultiLayerNetwork(tconf.replace(confs=tuple(
        c.replace(attention_impl="flash") for c in tconf.confs)),
        device="cpu")
    net.params = params_from_numpy(jparams, "cpu")
    breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=600.0)
    breaker.record_failure()
    server = net.serve(max_delay_ms=1, breaker=breaker)
    try:
        xs = _requests(rows=(2, 1), seed=8)
        answers = [_post(server.url, {"features": x.tolist(),
                                      "dtype": "int32"}) for x in xs]
        code, stats = _get(server.url, "/v1/stats")
    finally:
        server.drain()
    assert code == 200 and stats["degraded"]
    assert stats["breaker"]["state"] == "open"
    assert stats["degraded_batches"] == 2 and stats["errors"] == 0
    assert net.infer_cache.stats.steps == 0
    for x, ans in zip(xs, answers):
        want = net.output(x).float().numpy()
        got = np.asarray(ans["output"], np.float32)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    # the two references went through the cache: one bucket, one program
    assert (net.infer_cache.stats.misses, net.infer_cache.stats.hits) == (1, 1)


def test_deadlines_and_backpressure(nets):
    batcher = MicroBatcher(nets[2], max_delay_ms=1000, max_pending=1,
                           auto_start=False)
    with pytest.raises(DeadlineExceeded):
        batcher.predict(_requests()[0], deadline_ms=0)
    x = _requests(rows=(1,))[0]
    t = threading.Thread(target=lambda: pytest.raises(
        DeadlineExceeded, batcher.predict, x, timeout=10, deadline_ms=50))
    t.start()
    deadline = time.monotonic() + 10
    while batcher.queue_depth() < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(ServerOverloaded):
        batcher.predict(x, timeout=1)
    time.sleep(0.1)
    batcher.start()  # the queued request is past its deadline: evicted
    t.join(10)
    batcher.stop()
    assert batcher.stats()["deadline_misses"] == 2


def _post(url, body):
    req = urllib.request.Request(url + "/v1/predict",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_answers_concurrent_requests_and_drains(nets):
    server = nets[2].serve(max_delay_ms=200)
    try:
        assert _get(server.url, "/healthz") == (200, {"ok": True})
        assert _get(server.url, "/readyz") == (200, {"ready": True})
        xs = _requests(rows=(2, 1, 3), seed=3)
        answers = [None] * len(xs)

        def call(i):
            answers[i] = _post(server.url, {"features": xs[i].tolist(),
                                            "dtype": "int32"})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        for x, ans in zip(xs, answers):
            assert ans["rows"] == x.shape[0]
            np.testing.assert_allclose(np.asarray(ans["output"]),
                                       _jax_answer(nets, x), rtol=1e-4,
                                       atol=1e-4)
        code, stats = _get(server.url, "/v1/stats")
        assert code == 200 and stats["requests"] == 3
        assert stats["rows"] == 6 and stats["device"]["type"] == "cpu"
        code, body = _get(server.url, "/v1/nothing")
        assert code == 404
    finally:
        server.drain()
    assert not server.is_ready()
    with pytest.raises(ServerDraining):
        server.predict(_requests()[0])


def test_http_server_rejects_malformed_requests(nets):
    server = nets[2].serve(max_delay_ms=1)
    try:
        req = urllib.request.Request(
            server.url + "/v1/predict", data=b'{"no_features": 1}',
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(req, timeout=30)
        assert info.value.code == 400
    finally:
        server.drain()


@pytest.mark.parametrize("bad_id", [VOCAB, 300, -1])
def test_out_of_vocab_ids_get_400_and_the_server_keeps_answering(nets,
                                                                 bad_id):
    server = nets[2].serve(max_delay_ms=1)
    try:
        bad = _requests(rows=(2,), seed=5)[0]
        bad[1, 3] = bad_id
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(server.url, {"features": bad.tolist(), "dtype": "int32"})
        assert info.value.code == 400
        assert "token ids" in json.loads(info.value.read())["error"]
        x = _requests(rows=(2,), seed=6)[0]
        ans = _post(server.url, {"features": x.tolist(), "dtype": "int32"})
        np.testing.assert_allclose(np.asarray(ans["output"]),
                                   _jax_answer(nets, x), rtol=1e-4,
                                   atol=1e-4)
        stats = server.stats()
        assert stats["errors"] == 0 and stats["requests"] == 1
    finally:
        server.drain()


def test_bad_request_does_not_fail_the_batch_it_would_join(nets):
    good = _requests(rows=(1, 2), seed=7)
    bad = good[0].copy()
    bad[0, 0] = VOCAB + 5
    batcher = MicroBatcher(nets[2], max_delay_ms=1000, auto_start=False)
    with pytest.raises(ValueError, match="token ids"):
        batcher.predict(bad, timeout=1)
    assert batcher.queue_depth() == 0
    results, errors = _submit_all(batcher, good)
    assert errors == [None, None]
    for x, got in zip(good, results):
        np.testing.assert_allclose(got, _jax_answer(nets, x), rtol=1e-4,
                                   atol=1e-4)


def test_cli_serves_a_jax_checkpoint_and_drains_on_sigterm(nets, tmp_path):
    import os
    import signal
    import subprocess
    import sys

    from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint

    jconf, jparams, _ = nets
    ckpt = str(tmp_path / "ckpt")
    jax_checkpoint.save(ckpt, jparams, conf=jconf)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
         "--model", ckpt, "--device", "cpu", "--max-delay-ms", "1"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    try:
        startup = json.loads(proc.stdout.readline())
        assert startup["device"] == "cpu"
        x = _requests(rows=(2,), seed=4)[0]
        ans = _post(startup["url"], {"features": x.tolist(),
                                     "dtype": "int32"})
        np.testing.assert_allclose(np.asarray(ans["output"]),
                                   _jax_answer(nets, x), rtol=1e-4,
                                   atol=1e-4)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    drained = json.loads(out.strip().splitlines()[-1])
    assert drained["drained"] and drained["requests"] == 1


# -- dispatch order, stats, unbatched serving and default deadlines ------------------

class _FakeClock:
    """Stands in for a batcher module's `time`: `monotonic()` is what the
    test sets; the rest is the real module's."""

    def __init__(self, t):
        self.t = t
        self.perf_counter = time.perf_counter
        self.sleep = time.sleep
        self.time = time.time

    def monotonic(self):
        return self.t


class _StubNet:
    """What a MicroBatcher's dispatch reads of a network (nothing runs)."""

    class infer_cache:  # noqa: N801 — attribute namespace
        buckets = ()

    @staticmethod
    def check_input(x):
        pass


def _dispatch_order(batcher_cls, module, monkeypatch):
    """ROADMAP.md queue C's scenario through `batcher_cls`: shape A gets a
    "batch" request at t = 1 and an "interactive" one at t = 5 (queued
    ahead of it), shape B an "interactive" one at t = 3; max_delay 4 s.
    Returns [(shape, clock at the flush, priorities of the batch)]."""
    clock = _FakeClock(0.0)
    monkeypatch.setattr(module, "time", clock)
    b = batcher_cls(_StubNet(), max_delay_ms=4000, auto_start=False)
    flushed = []

    def execute(batch):
        flushed.append((batch[0].x.shape[1], clock.t,
                        [r.priority for r in batch]))
        for r in batch:
            r.result = r.x
            r.done.set()

    b._execute = execute
    threads = []
    for t, width, priority in ((1.0, 4, "batch"), (3.0, 6, "interactive"),
                               (5.0, 4, "interactive")):
        clock.t = t
        x = np.zeros((1, width), np.float32)
        th = threading.Thread(target=b.predict, args=(x,),
                              kwargs=dict(timeout=30, priority=priority))
        th.start()
        threads.append(th)
        deadline = time.monotonic() + 10
        while b.queue_depth() < len(threads) and \
                time.monotonic() < deadline:
            time.sleep(0.002)
    b.start()
    deadline = time.monotonic() + 5.0
    while not flushed and time.monotonic() < deadline:
        time.sleep(0.002)
    clock.t = 7.0  # B's own flush time, 3 + max_delay
    with b._cv:
        b._cv.notify_all()
    for th in threads:
        th.join(10)
    b.stop()
    return flushed


def test_dispatch_takes_the_queue_of_the_oldest_request_as_jax(monkeypatch):
    """The oldest live request (A's batch request, t = 1) picks the queue,
    although A's head is the later interactive one: A flushes first, at
    1 + max_delay, with both its requests, interactive first; then B at its
    own 3 + max_delay. The JAX batcher's arrival heap gives the same."""
    from deeplearning4j_tpu.serving import batcher as jax_batcher
    from deeplearning4j_tpu_torch.serving import batcher as port_batcher

    want = _dispatch_order(jax_batcher.MicroBatcher, jax_batcher,
                           monkeypatch)
    got = _dispatch_order(port_batcher.MicroBatcher, port_batcher,
                          monkeypatch)
    assert want == [(4, 5.0, ["interactive", "batch"]),
                    (6, 7.0, ["interactive"])]
    assert got == want


def _mixed_traffic(batcher, xs, expired):
    """Interactive and batch requests coalesced, one batch request that
    expires at enqueue, one that expires in the queue (`expired`: the
    package's DeadlineExceeded)."""
    prios = ["interactive", "batch", "interactive", "batch"]
    results = [None] * len(xs)

    def call(i):
        results[i] = batcher.predict(xs[i], timeout=30, priority=prios[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while batcher.queue_depth() < len(xs) and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(expired):
        batcher.predict(xs[0], deadline_ms=0, priority="batch")
    late = threading.Thread(target=lambda: pytest.raises(
        expired, batcher.predict, xs[1], timeout=10,
        deadline_ms=1, priority="interactive"))
    late.start()
    time.sleep(0.05)
    batcher.start()
    for t in threads + [late]:
        t.join(30)
    batcher.stop()
    return batcher.stats()


def test_stats_have_the_jax_batchers_priority_cache_and_compile_keys(nets):
    from deeplearning4j_tpu.reliability import \
        DeadlineExceeded as JaxDeadlineExceeded
    from deeplearning4j_tpu.serving.batcher import MicroBatcher as JaxBatcher

    jconf, jparams, net = nets
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, jparams)
    xs = _requests(rows=(1, 2, 1, 2), seed=8)
    want = _mixed_traffic(JaxBatcher(jnet, max_delay_ms=200,
                                     auto_start=False), xs,
                          JaxDeadlineExceeded)
    got = _mixed_traffic(MicroBatcher(net, max_delay_ms=200,
                                      auto_start=False), xs,
                         DeadlineExceeded)
    # the tuning block (`optimize/tunables.status()`) with JAX's keys
    assert set(got) == set(want)
    assert got["tuning"].keys() == want["tuning"].keys()
    assert set(got["cache"]) == set(want["cache"])
    assert got["fresh_compiles"] == net.infer_cache.stats.misses
    assert got["fresh_compiles"] == got["cache"]["misses"] >= 1
    assert got["deadline_misses"] == want["deadline_misses"] == 2
    for p in ("interactive", "batch"):
        g, w = got["priorities"][p], want["priorities"][p]
        assert set(g) == set(w) and set(g["latency_hist_s"]) == set(
            w["latency_hist_s"])
        assert g["requests"] == w["requests"] == 3
        assert g["queue_depth"] == w["queue_depth"] == 0
        assert g["latency_hist_s"]["bounds"] == \
            w["latency_hist_s"]["bounds"]
        h = g["latency_hist_s"]
        assert h["count"] == w["latency_hist_s"]["count"] == 2
        assert sum(h["counts"]) + h["inf"] == h["count"]
        assert g["latency_ms"]["p99"] >= g["latency_ms"]["p50"] > 0


def test_unbatched_server_answers_concurrent_requests(nets):
    """batching=False: each handler thread runs `net.output` (its graph
    replays are serialised under the pool's lock); every answer is its
    request's own, and the batcher sees none of them, as in JAX."""
    server = nets[2].serve(batching=False)
    try:
        xs = _requests(rows=(2, 1, 3, 2, 1, 2), seed=9)
        answers = [None] * len(xs)

        def call(i):
            answers[i] = _post(server.url, {"features": xs[i].tolist(),
                                            "dtype": "int32"})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        for x, ans in zip(xs, answers):
            assert ans["rows"] == x.shape[0]
            np.testing.assert_allclose(np.asarray(ans["output"]),
                                       _jax_answer(nets, x), rtol=1e-4,
                                       atol=1e-4)
        bad = xs[0].copy()
        bad[0, 0] = VOCAB
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(server.url, {"features": bad.tolist(), "dtype": "int32"})
        assert info.value.code == 400
        stats = server.stats()
        assert stats["batching"] is False and stats["requests"] == 0
    finally:
        server.drain()


def _status(url, body):
    try:
        _post(url, body)
        return 200
    except urllib.error.HTTPError as e:
        return e.code


def test_default_deadline_ms_answers_504_past_it_as_jax(nets):
    """A request that names no deadline takes the server's default: past
    it in the queue, 504; one that names its own waits for the flush."""
    from deeplearning4j_tpu.serving.server import ModelServer as JaxServer

    jconf, jparams, net = nets
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, jparams)
    x = _requests(rows=(2,), seed=10)[0]
    codes = {}
    for name, server in (
            ("jax", JaxServer(jnet, max_delay_ms=300,
                              default_deadline_ms=20).start()),
            ("port", net.serve(max_delay_ms=300, default_deadline_ms=20))):
        try:
            codes[name] = [
                _status(server.url, {"features": x.tolist(),
                                     "dtype": "int32"}),
                _status(server.url, {"features": x.tolist(),
                                     "dtype": "int32",
                                     "deadline_ms": 10000})]
            stats = server.stats()
            codes[name] += [stats["deadline_misses"],
                            stats["priorities"]["interactive"]["requests"]]
        finally:
            server.drain()
    assert codes["port"] == codes["jax"] == [504, 200, 1, 2]

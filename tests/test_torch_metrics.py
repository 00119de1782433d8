"""The port's Prometheus rendering (`serving/metrics.py`), `GET /metrics`
on its `ModelServer` and the router over port replicas, on the JAX
package's `tests/test_serving_fabric.py` scenarios: priority classes in
the coalescing queue, text-format conformance and monotonic counters on a
replica and on the router, the quarantine and multi-host families, the
generation and decode-option families, the precision policy's labels, the
router's routing, ejection, drain and 503, and the two-replica CLI smoke
with a request in flight at SIGTERM. Then the renderings against JAX's:
`replica_metrics`, `router_metrics` and `parse_prometheus_text` give the
same text and series for the same stats dicts (a port server's, a port
router's with its fleet attached, and recorded ones), and the `tuning`
families read the port's status block.

CPU only; the subprocess smoke uses short drain timeouts."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu_torch.models.zoo import mlp  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import tunables  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.serving import (PRIORITIES,  # noqa: E402
                                              FleetSupervisor, MicroBatcher,
                                              Router, parse_prometheus_text,
                                              replica_metrics,
                                              router_metrics)


@pytest.fixture(autouse=True)
def _clean_tunables():
    tunables.clear()
    yield
    tunables.clear()

N_IN, N_OUT = 6, 3


def _net(seed=0):
    return MultiLayerNetwork(mlp(n_in=N_IN, hidden=[8], n_out=N_OUT,
                                 lr=0.05), device="cpu", seed=seed).init()


def _x(rows, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(rows, N_IN).astype(np.float32)


def _http(url, body=None, timeout=30):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- priority classes in the coalescing queue --------------------------------

def test_priority_validation():
    b = MicroBatcher(_net(), auto_start=False)
    with pytest.raises(ValueError):
        b.predict(_x(1), priority="urgent")


def test_interactive_preempts_queued_batch():
    """With the dispatcher parked, enqueue batch-class requests then an
    interactive one: the queue must hold [interactive, batch, batch] so
    the next flush serves the user-facing rows first."""
    b = MicroBatcher(_net(), auto_start=False)  # dispatcher never starts
    done = []

    def enqueue(prio, i):
        try:
            b.predict(_x(1, seed=i), timeout=30.0, priority=prio)
            done.append((prio, i))
        except Exception:  # noqa: BLE001 — drain answers them later
            pass

    threads = []
    for i, prio in enumerate(["batch", "batch", "interactive", "batch"]):
        t = threading.Thread(target=enqueue, args=(prio, i))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 10.0
        while b.queue_depth() < i + 1 and time.monotonic() < deadline:
            time.sleep(0.005)
    assert b.queue_depth() == 4
    with b._cv:
        (q,) = b._queues.values()
        order = [r.priority for r in q]
    assert order == ["interactive", "batch", "batch", "batch"]
    st = b.stats()
    assert st["priorities"]["interactive"]["queue_depth"] == 1
    assert st["priorities"]["batch"]["queue_depth"] == 3
    b.start()
    b.stop()  # drain-on-stop answers everyone
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert len(done) == 4


def test_per_priority_latency_histograms_accumulate():
    net = _net()
    net.warmup([4])
    b = MicroBatcher(net, max_delay_ms=1.0).start()
    try:
        b.predict(_x(2), timeout=30.0, priority="interactive")
        b.predict(_x(2), timeout=30.0, priority="batch")
    finally:
        b.stop()
    st = b.stats()
    for prio in PRIORITIES:
        h = st["priorities"][prio]["latency_hist_s"]
        assert sum(h["counts"]) + h["inf"] == h["count"] == 1
        assert h["sum"] > 0.0
        assert st["priorities"][prio]["requests"] == 1


# -- Prometheus text-format conformance --------------------------------------

def _assert_monotonic(before: dict, after: dict):
    """Every counter/histogram-cumulative series only ever moves up."""
    for name, series in before.items():
        if not (name.endswith("_total") or name.endswith("_bucket")
                or name.endswith("_count") or name.endswith("_sum")):
            continue
        for labels, value in series.items():
            assert after[name][labels] >= value, (name, labels)


def test_replica_metrics_conformance_and_monotonic_counters():
    net = _net()
    net.warmup([4])
    server = net.serve(max_delay_ms=1.0)
    try:
        _http(server.url + "/v1/predict",
              {"features": _x(2, seed=1).tolist(), "priority": "batch"})
        code, text1 = _http(server.url + "/metrics")
        assert code == 200
        parsed1 = parse_prometheus_text(text1)  # raises on any bad line
        for family in ("dl4j_serving_queue_depth",
                       "dl4j_serving_batch_rows_bucket",
                       "dl4j_serving_request_latency_seconds_bucket",
                       "dl4j_serving_breaker_state",
                       "dl4j_serving_cache_hits_total",
                       "dl4j_serving_cache_disk_hits_total",
                       "dl4j_serving_cache_fetch_hits_total",
                       "dl4j_serving_cache_fetch_corrupt_total"):
            assert family in parsed1, family
        # priority label present on the latency histogram
        lat = parsed1["dl4j_serving_request_latency_seconds_bucket"]
        prios = {dict(lbl).get("priority") for lbl in lat}
        assert prios == set(PRIORITIES)
        _http(server.url + "/v1/predict",
              {"features": _x(3, seed=2).tolist()})
        code, text2 = _http(server.url + "/metrics")
        parsed2 = parse_prometheus_text(text2)
        _assert_monotonic(parsed1, parsed2)
        # and the second scrape actually observed the new request
        key = (("priority", "interactive"),)
        assert (parsed2["dl4j_serving_requests_total"][key]
                > parsed1["dl4j_serving_requests_total"][key])
    finally:
        server.stop()


def test_metrics_content_type_and_histogram_shape():
    net = _net()
    net.warmup([4])
    text = replica_metrics(net.serve(max_delay_ms=1.0).stats())
    parsed = parse_prometheus_text(text)
    buckets = parsed["dl4j_serving_batch_rows_bucket"]
    infs = [v for lbl, v in buckets.items() if dict(lbl)["le"] == "+Inf"]
    assert len(infs) == 1
    assert infs[0] == parsed["dl4j_serving_batch_rows_count"][()]


def test_quarantine_gauge_and_multihost_families_conformance():
    """`dl4j_fleet_quarantine_remaining_seconds`
    counts down on the supervisor's own (injected) clock,
    `quarantined_until` appears in stats(), and every new multi-host
    family — fleet partition/failover counters, per-agent lease
    families, per-host router rollups — renders to strictly parseable
    text whose counters only move up across scrapes."""

    class _Clock:
        t = 100.0

        def __call__(self):
            return self.t

    class _DeadHandle:
        """A handle that is dead on arrival: one tick books the death
        and (max_restarts=1) quarantines the slot."""

        url = None
        summary = None

        def poll(self):
            return 1

        def wait_ready(self):
            return {}

        def terminate(self):
            pass

        def kill(self):
            pass

        def wait(self, timeout=None):
            return 1

    clk = _Clock()
    # one never-polled replica keeps the per-host rollup non-empty; the
    # agent URL is unreachable, so the first heartbeat partitions it
    # (lease_misses=1) — every new family gets a non-trivial value
    router = Router(["http://127.0.0.1:9/dead"],
                    poll_interval_s=3600.0).start()
    sup = FleetSupervisor(spawn_fn=_DeadHandle, router=router,
                          initial=[_DeadHandle()], min_replicas=1,
                          max_replicas=1, max_restarts=1,
                          restart_window_s=1000.0, quarantine_s=60.0,
                          agents=["http://127.0.0.1:9/agent"],
                          remote_argv=["serve"], lease_misses=1,
                          agent_failover_s=1e9, clock=clk)
    try:
        sup.tick()
        st = sup.stats()
        assert st["states"]["quarantined"] == 1
        slot = st["slots"][0]
        assert slot["quarantined_until"] == pytest.approx(160.0)
        assert slot["quarantine_remaining_s"] == pytest.approx(60.0)
        assert st["agents"][0]["state"] == "partitioned"
        router.attach_fleet(sup)
        text1 = router_metrics(router.stats())
        parsed1 = parse_prometheus_text(text1)  # strict: raises on junk
        for fam in ("dl4j_fleet_quarantine_remaining_seconds",
                    "dl4j_fleet_partitions_total",
                    "dl4j_fleet_failovers_total",
                    "dl4j_router_host_replicas",
                    "dl4j_router_host_breaker_opens_total",
                    "dl4j_agent_up", "dl4j_agent_replicas",
                    "dl4j_agent_partitions_total",
                    "dl4j_agent_reconciles_total",
                    "dl4j_agent_adopted_total",
                    "dl4j_agent_orphans_stopped_total",
                    "dl4j_agent_failovers_total"):
            assert fam in parsed1, fam
        q = parsed1["dl4j_fleet_quarantine_remaining_seconds"]
        assert q[(("slot", "0"),)] == pytest.approx(60.0)
        assert parsed1["dl4j_fleet_partitions_total"][()] == 1
        assert parsed1["dl4j_router_host_replicas"][
            (("host", "local"),)] == 1
        (agent_lbl,) = parsed1["dl4j_agent_up"]
        assert dict(agent_lbl).keys() == {"agent"}   # label set stable
        assert parsed1["dl4j_agent_up"][agent_lbl] == 0  # partitioned
        # the gauge counts DOWN on the supervisor's clock while every
        # counter stays monotonic
        clk.t += 25.0
        sup.tick()
        parsed2 = parse_prometheus_text(router_metrics(router.stats()))
        _assert_monotonic(parsed1, parsed2)
        assert parsed2["dl4j_fleet_quarantine_remaining_seconds"][
            (("slot", "0"),)] == pytest.approx(35.0)
        assert (sup.stats()["slots"][0]["quarantined_until"]
                == pytest.approx(160.0))
    finally:
        sup.stop()
        router.stop()


def test_generation_metrics_conformance_and_monotonic(tmp_path):
    """The generation families — tokens counter, TTFT histogram, decode
    slot gauge — render to strictly-parseable text and the counters
    only move up across scrapes with traffic in between."""
    from deeplearning4j_tpu_torch.models.zoo import char_lstm

    net = MultiLayerNetwork(char_lstm(11, hidden=12, n_layers=1),
                            device="cpu", seed=0).init()
    net.warmup_generate(slots=2, max_seq=16, prompt_buckets=(8,))
    server = net.serve(generate=True, gen_slots=2, gen_max_seq=16,
                       gen_prompt_buckets=(8,))
    try:
        _http(server.url + "/v1/generate",
              {"prompt": [1, 2], "max_new_tokens": 4})
        code, text1 = _http(server.url + "/metrics")
        assert code == 200
        parsed1 = parse_prometheus_text(text1)  # raises on any bad line
        for family in ("dl4j_serving_tokens_total",
                       "dl4j_serving_ttft_seconds_bucket",
                       "dl4j_serving_ttft_seconds_count",
                       "dl4j_serving_decode_slots"):
            assert family in parsed1, family
        # the slot gauge carries the state label, both states present
        states = {dict(lbl).get("state")
                  for lbl in parsed1["dl4j_serving_decode_slots"]}
        assert states == {"active", "free"}
        # one completed 4-token stream is on the counter and histogram
        assert list(parsed1["dl4j_serving_tokens_total"].values())[0] >= 4
        assert list(
            parsed1["dl4j_serving_ttft_seconds_count"].values())[0] >= 1
        _http(server.url + "/v1/generate",
              {"prompt": [3], "max_new_tokens": 3})
        code, text2 = _http(server.url + "/metrics")
        parsed2 = parse_prometheus_text(text2)
        _assert_monotonic(parsed1, parsed2)
        assert (list(parsed2["dl4j_serving_tokens_total"].values())[0]
                > list(parsed1["dl4j_serving_tokens_total"].values())[0])
    finally:
        server.stop()


def test_decode_accelerator_metrics_conformance_and_monotonic():
    """The decode-option families — KV page-pool gauge, prefix-cache hit and
    miss counters, accepted-tokens-per-step histogram — render to
    strictly-parseable text with exactly the declared label sets, the
    counters only move up across scrapes, and the pre-existing
    generation families keep their label sets untouched."""
    from deeplearning4j_tpu_torch.models.zoo import char_lstm

    net = MultiLayerNetwork(char_lstm(11, hidden=12, n_layers=1),
                            device="cpu", seed=0).init()
    draft = MultiLayerNetwork(char_lstm(11, hidden=8, n_layers=1),
                              device="cpu", seed=1).init()
    net.warmup_generate(slots=2, max_seq=16, prompt_buckets=(8,),
                        page_size=4, prefix_cache=True, draft_net=draft,
                        spec_k=2)
    server = net.serve(generate=True, gen_slots=2, gen_max_seq=16,
                       gen_prompt_buckets=(8,), gen_page_size=4,
                       gen_prefix_cache=True, gen_draft=draft,
                       gen_spec_k=2)
    try:
        _http(server.url + "/v1/generate",
              {"prompt": [1, 2], "max_new_tokens": 4})
        code, text1 = _http(server.url + "/metrics")
        assert code == 200
        parsed1 = parse_prometheus_text(text1)  # raises on any bad line
        for family in ("dl4j_serving_kv_pages",
                       "dl4j_serving_prefix_cache_hits_total",
                       "dl4j_serving_prefix_cache_misses_total",
                       "dl4j_serving_accepted_tokens_per_step_bucket",
                       "dl4j_serving_accepted_tokens_per_step_count"):
            assert family in parsed1, family
        # the page gauge carries the state label, both states present
        states = {dict(lbl).get("state")
                  for lbl in parsed1["dl4j_serving_kv_pages"]}
        assert states == {"free", "live"}
        # the pre-existing slot gauge kept its exact label set
        assert {dict(lbl).get("state")
                for lbl in parsed1["dl4j_serving_decode_slots"]} == {
                    "active", "free"}
        misses1 = list(
            parsed1["dl4j_serving_prefix_cache_misses_total"].values())[0]
        assert misses1 >= 1  # the cold first prompt
        # the same prompt again: a prefix hit, and every counter and
        # cumulative histogram series only moved up
        _http(server.url + "/v1/generate",
              {"prompt": [1, 2], "max_new_tokens": 4})
        code, text2 = _http(server.url + "/metrics")
        parsed2 = parse_prometheus_text(text2)
        _assert_monotonic(parsed1, parsed2)
        assert list(
            parsed2["dl4j_serving_prefix_cache_hits_total"].values())[0] >= 1
        assert (list(
            parsed2["dl4j_serving_accepted_tokens_per_step_count"].values()
        )[0] >= list(
            parsed1["dl4j_serving_accepted_tokens_per_step_count"].values()
        )[0])
    finally:
        server.stop()


def test_parser_rejects_malformed_lines():
    with pytest.raises(ValueError):
        parse_prometheus_text("this is not a metric line\n")
    with pytest.raises(ValueError):
        parse_prometheus_text("# TYPE foo widget\n")
    with pytest.raises(ValueError):
        parse_prometheus_text("ok_metric 1\nok_metric 2\n")  # dup series


# -- serve-precision policy on the wire ---------------------------------------

def test_precision_policy_metrics_and_label_conformance():
    """The policy shows up as an info gauge, a per-policy row counter,
    and a `policy=` label on the cache/latency families — while the
    pre-existing request/batch families keep their exact label sets."""
    net = _net()
    net.set_serve_precision("int8", measure=False)
    net.warmup([4])
    server = net.serve(max_delay_ms=1.0)
    try:
        code, body = _http(server.url + "/v1/predict",
                           {"features": _x(2, seed=1).tolist()})
        assert code == 200, body
        code, text = _http(server.url + "/metrics")
        assert code == 200
        parsed = parse_prometheus_text(text)
        assert parsed["dl4j_serving_precision_policy_info"][
            (("policy", "int8"),)] == 1
        assert parsed["dl4j_serving_policy_rows_total"][
            (("policy", "int8"),)] >= 2
        for fam in ("dl4j_serving_cache_hits_total",
                    "dl4j_serving_cache_misses_total",
                    "dl4j_serving_cache_disk_hits_total",
                    "dl4j_serving_cache_io_errors_total"):
            assert set(parsed[fam]) == {(("policy", "int8"),)}, fam
        for lbl in parsed["dl4j_serving_request_latency_seconds_count"]:
            d = dict(lbl)
            assert d["policy"] == "int8" and d["priority"] in PRIORITIES
        # unchanged families: priority-only requests, unlabeled batch rows
        assert set(parsed["dl4j_serving_requests_total"]) == {
            (("priority", "interactive"),), (("priority", "batch"),)}
        assert set(parsed["dl4j_serving_batch_rows_count"]) == {()}
    finally:
        server.stop()


def test_stats_programs_block_lists_policy_tuples():
    net = _net()
    net.warmup([4])
    net.set_serve_precision("bf16", measure=False)
    net.warmup([4])
    server = net.serve(max_delay_ms=1.0)
    try:
        code, body = _http(server.url + "/v1/stats")
        assert code == 200
        st = json.loads(body)
        rows = {(p["entry"], p["bucket"], p["sharding"], p["policy"])
                for p in st["programs"]}
        assert ("output", 4, "single", "f32") in rows
        assert ("output", 4, "single", "bf16") in rows
        assert st["precision"]["policy"] == "bf16"
    finally:
        server.stop()


def test_router_preserves_policy_label_and_aggregates_rows():
    nets = [_net(seed=0), _net(seed=0)]
    for n in nets:
        n.set_serve_precision("bf16", measure=False)
        n.warmup([4])
    servers = [n.serve(max_delay_ms=1.0) for n in nets]
    router = Router([s.url for s in servers],
                    poll_interval_s=3600.0).start()
    try:
        for i in range(4):
            code, body = _http(router.url + "/v1/predict",
                               {"features": _x(2, seed=i).tolist()})
            assert code == 200, body
        router.poll_once()
        st = router.stats()
        assert st["rows_by_policy"] == {"bf16": 8}
        parsed = parse_prometheus_text(router_metrics(st))
        assert parsed["dl4j_router_policy_rows_total"][
            (("policy", "bf16"),)] == 8
        # replica re-export keeps the policy label alongside `replica`
        info = parsed["dl4j_serving_precision_policy_info"]
        assert {dict(lbl)["policy"] for lbl in info} == {"bf16"}
        assert {dict(lbl)["replica"] for lbl in info} == {"0", "1"}
    finally:
        router.stop()
        for s in servers:
            s.stop()


# -- router over in-process ModelServers -------------------------------------

def _start_pair(poll_interval_s=0.1):
    nets = [_net(seed=0), _net(seed=0)]
    for n in nets:
        n.warmup([4])
    servers = [n.serve(max_delay_ms=1.0) for n in nets]
    router = Router([s.url for s in servers],
                    poll_interval_s=poll_interval_s).start()
    return servers, router


def test_router_routes_and_reports():
    servers, router = _start_pair()
    try:
        for i in range(4):
            code, body = _http(router.url + "/v1/predict",
                               {"features": _x(2, seed=i).tolist(),
                                "priority": PRIORITIES[i % 2]})
            assert code == 200, body
            assert len(json.loads(body)["output"]) == 2
        st = router.stats()
        assert st["healthy_replicas"] == 2
        assert sum(p["requests"] for p in st["priorities"].values()) == 4
        # round-robin actually spread the work
        per_replica = [r["stats"]["requests"] if r["stats"] else 0
                       for r in st["replicas"]]
        router.poll_once()
        per_replica = [r["stats"]["requests"] if r["stats"] else 0
                       for r in router.stats()["replicas"]]
        assert all(n >= 1 for n in per_replica), per_replica
        code, text = _http(router.url + "/metrics")
        assert code == 200
        parsed = parse_prometheus_text(text)
        assert "dl4j_router_requests_total" in parsed
        # replica-labeled re-export of the serving families
        reps = {dict(lbl).get("replica")
                for lbl in parsed["dl4j_serving_rows_total"]}
        assert reps == {"0", "1"}
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_router_ejects_dead_replica_and_recovers_traffic():
    # background poller parked (huge interval): health transitions are
    # driven deterministically by poll_once(), with no stale in-flight
    # poll racing the assertions below
    servers, router = _start_pair(poll_interval_s=3600.0)
    try:
        servers[0].stop()          # replica 0 gone: connections refused
        router.poll_once()
        assert router.healthy_count() == 1
        # every request still lands (on replica 1), possibly via retry
        for i in range(4):
            code, body = _http(router.url + "/v1/predict",
                               {"features": _x(1, seed=i).tolist()})
            assert code == 200, body
        assert router.is_ready()   # 1 healthy replica keeps readyz 200
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_router_drain_stops_admission():
    servers, router = _start_pair()
    try:
        router.drain(timeout_s=5.0)
        # replicas outlive the router drain (the CLI terminates them
        # afterwards, so their own drains can finish queued work)
        assert all(s.is_ready() for s in servers)
        with pytest.raises((urllib.error.URLError, ConnectionError)):
            _http(router.url + "/readyz")  # front door is closed
    finally:
        for s in servers:
            s.stop()


def test_router_503_when_no_replica():
    net = _net()
    net.warmup([4])
    server = net.serve(max_delay_ms=1.0)
    # poller parked — poll_once() drives health (see ejection test)
    router = Router([server.url], poll_interval_s=3600.0).start()
    try:
        server.stop()
        assert router.poll_once() == 0
        code, body = _http(router.url + "/v1/predict",
                           {"features": _x(1).tolist()})
        assert code == 503, body
        assert router.stats()["unroutable"] >= 1
        code, _ = _http(router.url + "/readyz")
        assert code == 503
    finally:
        router.stop()


def test_router_metrics_parse_without_traffic():
    servers, router = _start_pair()
    try:
        parsed = parse_prometheus_text(router_metrics(router.stats()))
        assert parsed["dl4j_router_replicas_healthy"][()] == 2
    finally:
        router.stop()
        for s in servers:
            s.stop()


# -- the real thing: 2-replica CLI router, warmed cache, SIGTERM drain -------

def test_cli_router_two_replicas_warmed_drain_exit_zero(tmp_path):
    """The JAX package's two-replica smoke on the port's CLI: both
    replicas start warmed; a fault-harness delay keeps a request in flight
    when SIGTERM lands; the router and replicas drain answering every
    accepted request and exit 0."""
    net = _net()
    ckpt = str(tmp_path / "model")
    cache = str(tmp_path / "cache")
    checkpoint.save(ckpt, net.params, conf=net.conf)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo,
           # the fault harness: every dispatcher execute sleeps 200ms,
           # so the straggler below is genuinely in flight at SIGTERM
           "DL4J_FAULT_PLAN": "dispatcher.execute=delay:0.2"}
    subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "warmup",
         "--model", ckpt, "--compile-cache", cache, "--shapes", "4",
         "--device", "cpu"],
        check=True, capture_output=True, cwd=repo, env=env, timeout=300)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
         "--model", ckpt, "--compile-cache", cache, "--shapes", "4",
         "--replicas", "2", "--port", "0", "--max-delay-ms", "50",
         "--drain-timeout", "10", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=repo, env=env)
    try:
        watchdog = threading.Timer(240.0, proc.kill)
        watchdog.start()
        try:
            summary = json.loads(proc.stdout.readline())
        finally:
            watchdog.cancel()
        url = summary["url"]
        assert len(summary["replicas"]) == 2
        # each replica makes its one warmed program at start (a graph is
        # not kept on disk); nothing more under traffic
        assert summary["fresh_compiles"] == [1, 1]

        code, body = _http(url + "/v1/predict",
                           {"features": _x(2, seed=1).tolist()}, timeout=60)
        assert code == 200 and json.loads(body)["rows"] == 2

        # metrics scrape parses and counters are monotonic across scrapes
        code, text1 = _http(url + "/metrics", timeout=60)
        assert code == 200
        parsed1 = parse_prometheus_text(text1)
        _http(url + "/v1/predict",
              {"features": _x(1, seed=3).tolist(), "priority": "batch"},
              timeout=60)
        code, text2 = _http(url + "/metrics", timeout=60)
        parsed2 = parse_prometheus_text(text2)
        _assert_monotonic(parsed1, parsed2)

        # leave a request IN FLIGHT (50ms coalesce + 200ms fault delay)
        # when the SIGTERM lands: the fleet drain must still answer it
        inflight = {}

        def straggler():
            try:
                inflight["resp"] = _http(
                    url + "/v1/predict",
                    {"features": _x(1, seed=2).tolist()}, timeout=60)
            except Exception as e:  # noqa: BLE001
                inflight["error"] = e

        t = threading.Thread(target=straggler)
        t.start()
        time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=90.0)
        assert not t.is_alive()
        assert "resp" in inflight, inflight.get("error")
        assert inflight["resp"][0] == 200

        out, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, (out, err)
        drained = json.loads(out.strip().splitlines()[-1])
        assert drained["drained"] is True
        assert drained["replica_exit_codes"] == [0, 0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- the renderings against JAX's ----------------------------------------------

def _jax_metrics():
    from deeplearning4j_tpu.serving import metrics as jm
    return jm


def test_declared_families_and_constants_equal_jaxs():
    from deeplearning4j_tpu_torch.serving import metrics as pm

    jm = _jax_metrics()
    assert pm.FAMILIES == jm.FAMILIES
    assert pm.CONTENT_TYPE == jm.CONTENT_TYPE
    assert pm.BATCH_ROWS_BOUNDS == jm.BATCH_ROWS_BOUNDS
    for v in ("plain", 'quo"te', "back\\slash", "new\nline"):
        assert pm.escape_label_value(v) == jm.escape_label_value(v)


def _served_stats():
    """A port server's stats after traffic of both priorities, with the
    tuning block of an installed table and the generation block."""
    from deeplearning4j_tpu_torch.models.zoo import char_lstm

    tunables.install(tunables.TunedTable(
        {"decode.slots": 2}, device_kind="cpu", fingerprint="f"),
        source="disk")
    tunables.note_fresh(2)
    net = MultiLayerNetwork(char_lstm(11, hidden=12, n_layers=1),
                            device="cpu", seed=0).init()
    net.warmup_generate(slots=2, max_seq=16, prompt_buckets=(8,),
                        page_size=4, prefix_cache=True)
    server = net.serve(max_delay_ms=1.0, generate=True, gen_slots=2,
                       gen_max_seq=16, gen_prompt_buckets=(8,),
                       gen_page_size=4, gen_prefix_cache=True)
    try:
        x = np.eye(11, dtype=np.float32)[None, :4]
        for prio in PRIORITIES:
            code, body = _http(server.url + "/v1/predict",
                               {"features": x.tolist(), "priority": prio})
            assert code == 200, body
        for _ in range(2):
            _http(server.url + "/v1/generate",
                  {"prompt": [1, 2], "max_new_tokens": 4})
        code, text = _http(server.url + "/metrics")
        assert code == 200
        stats = server.stats()
    finally:
        server.stop()
    return stats, text


def test_replica_metrics_text_equals_jaxs_for_a_port_servers_stats():
    jm = _jax_metrics()
    stats, served_text = _served_stats()
    assert stats["tuning"]["tuned_tables"] == 1
    mine = replica_metrics(stats)
    assert mine == jm.replica_metrics(stats)
    parsed = parse_prometheus_text(mine)
    assert parsed == jm.parse_prometheus_text(mine)
    assert parsed["dl4j_tuning_table_info"][(("device_kind", "cpu"),)] == 1
    assert parsed["dl4j_tuning_fresh_tunes_total"][()] == 2
    for fam in ("dl4j_serving_tokens_total", "dl4j_serving_kv_pages",
                "dl4j_serving_prefix_cache_hits_total"):
        assert fam in parsed, fam
    # GET /metrics serves the same families
    assert set(parse_prometheus_text(served_text)) == set(parsed)


RECORDED = [
    {},
    {"ready": True, "inflight": 3, "rows": 12, "errors": 1,
     "batch_rows_hist": {"1": 4, "3": 1, "2048": 2},
     "breaker": {"state": "half_open", "opens": 2},
     "precision": {"policy": "int8", "rows_by_policy": {"f32": 4,
                                                        "int8": 8},
                   "report": {"accuracy_delta": {"top1": 0.02,
                                                 "rel_mse": 1e-3}}},
     "cache": {"hits": 5, "misses": 2, "fetch_hits": 1},
     "tuning": {"tuned_tables": 1, "fresh_tunes": 0, "entries": 4,
                "device_kind": "NVIDIA H100 80GB HBM3", "source": "disk"},
     "priorities": {"interactive": {"queue_depth": 1, "requests": 7,
                                    "latency_hist_s": {
                                        "bounds": [0.001, 0.01],
                                        "counts": [1, 2], "inf": 1,
                                        "sum": 0.5, "count": 4}}}},
    {"tuning": {"tuned_tables": 0, "fresh_tunes": 0, "entries": 0,
                "device_kind": "", "source": ""},
     "generation": {"tokens": 9, "slots": {"active": 1, "free": 3},
                    "ttft_hist_s": {"bounds": [0.1], "counts": [2],
                                    "inf": 0, "sum": 0.1, "count": 2},
                    "decode_block_steps": {"bounds": [1, 2],
                                           "counts": [3, 1], "inf": 0,
                                           "sum": 5, "count": 4},
                    "decode_host_seconds_total": 0.25}},
]


@pytest.mark.parametrize("stats", RECORDED)
def test_replica_metrics_text_equals_jaxs_for_recorded_stats(stats):
    jm = _jax_metrics()
    text = replica_metrics(stats)
    assert text == jm.replica_metrics(stats)
    assert parse_prometheus_text(text) == jm.parse_prometheus_text(text)


def test_router_metrics_text_equals_jaxs_with_the_fleet_attached():
    from deeplearning4j_tpu_torch.serving import Autoscaler

    jm = _jax_metrics()
    servers, router = _start_pair(poll_interval_s=3600.0)

    class _Handle:
        def __init__(self, server):
            self.server = server
            self.summary = {"url": server.url, "fresh_compiles": 1,
                            "tuning": tunables.status()}

        @property
        def url(self):
            return self.server.url

        def wait_ready(self):
            return self.summary

        def poll(self):
            return None

        def terminate(self):
            pass

        def kill(self):
            pass

        def wait(self, timeout=None):
            return 0

    sup = FleetSupervisor(spawn_fn=None, router=router,
                          initial=[_Handle(s) for s in servers],
                          min_replicas=2, max_replicas=3)
    auto = Autoscaler(router, sup)
    router.attach_fleet(sup, auto)
    try:
        for i in range(3):
            _http(router.url + "/v1/predict",
                  {"features": _x(2, seed=i).tolist(),
                   "priority": PRIORITIES[i % 2]})
        router.poll_once()
        auto.evaluate_once()
        st = router.stats()
        text = router_metrics(st)
        assert text == jm.router_metrics(st)
        parsed = parse_prometheus_text(text)
        assert parsed == jm.parse_prometheus_text(text)
        assert parsed["dl4j_fleet_replicas"][(("state", "running"),)] == 2
        code, served = _http(router.url + "/metrics")
        assert code == 200
        assert set(parse_prometheus_text(served)) == set(parsed)
    finally:
        sup.stop()
        router.stop()
        for s in servers:
            s.stop()


@pytest.mark.parametrize("text", [
    "this is not a metric line\n", "# TYPE foo widget\n",
    "ok_metric 1\nok_metric 2\n", "m{a=\"1\"} 1\n# HELP m x\n"])
def test_the_parser_refuses_what_jaxs_refuses(text):
    jm = _jax_metrics()
    outcomes = []
    for parse in (parse_prometheus_text, jm.parse_prometheus_text):
        try:
            outcomes.append(parse(text))
        except ValueError:
            outcomes.append("refused")
    assert outcomes[0] == outcomes[1]

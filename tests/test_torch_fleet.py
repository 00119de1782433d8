"""The port's serving fleet (`serving/router.py`, `supervisor.py`,
`autoscaler.py`, `agent.py`, `cachesync.py`, `reliability/budget.py`) on
the JAX package's `tests/test_fleet.py` scenarios: retry budget, hedged
requests, mutable router rotation, staleness, concurrent polling,
supervision (respawn/backoff/quarantine), autoscaling, the agent control
plane and lease-based remote supervision, failure-domain hedging, the
fleet's Prometheus families; the replicas are the port's `ModelServer`s
over an MLP on the CPU where JAX's are its own. Where the outcome is
deterministic it is compared with the JAX modules' on the same recorded
inputs: the budget's token sequence, the autoscaler's decisions over a
recorded stats sequence, the router's rotation after adds and removes.
Then the store's entries over the cachesync wire (the tuned table, a
corrupt fetch counted), and the CLI: `serve --replicas 2` answers as the
single process, heals a SIGKILLed replica and drains to exit 0, its
replicas inherit the tuned table; `agent` on an empty store serves
through `serve --agent` with the table fetched over the wire.

CPU only; in-process pieces are driven deterministically (parked
pollers, `tick()`/`evaluate_once()` by hand, injectable clocks and
backoff), the subprocesses run under short timeouts and a watchdog."""

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
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu_torch.models.zoo import mlp  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import tunables  # noqa: E402
from deeplearning4j_tpu_torch.optimize.step_cache import \
    conf_fingerprint  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import (RetryBudget,  # noqa: E402
                                                  faults)
from deeplearning4j_tpu_torch.serving import (AgentClient,  # noqa: E402
                                              Autoscaler, CacheFetcher,
                                              CacheServer, CircuitBreaker,
                                              FleetSupervisor, ReplicaAgent,
                                              Router, parse_prometheus_text,
                                              router_metrics)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_IN, N_OUT = 6, 3


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    tunables.clear()
    yield
    faults.reset()
    tunables.clear()


def _net(seed=0):
    net = MultiLayerNetwork(mlp(n_in=N_IN, hidden=[8], n_out=N_OUT,
                                lr=0.05), device="cpu", seed=seed).init()
    net.warmup([1, 2, 4])
    return net


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


def _start_fleet(n=2, poll_interval_s=3600.0, **router_kw):
    """N warmed in-process replicas behind a router whose background
    poller is parked (huge interval): health transitions are driven by
    poll_once(), deterministically."""
    servers = [_net(seed=0).serve(max_delay_ms=1.0) for _ in range(n)]
    router = Router([s.url for s in servers],
                    poll_interval_s=poll_interval_s, **router_kw).start()
    return servers, router


def _stop_all(router, servers):
    router.stop()
    for s in servers:
        s.stop()


class _FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class _Handle:
    """In-process stand-in for `ReplicaProcess`: a real `ModelServer`
    with a settable exit code, so supervisor tests reap/respawn without
    subprocess spawn cost."""

    def __init__(self):
        self.server = _net(seed=0).serve(max_delay_ms=1.0)
        self._rc = None
        self.summary = {"url": self.server.url, "fresh_compiles": 0}

    @property
    def url(self):
        return self.server.url

    def wait_ready(self):
        return self.summary

    def poll(self):
        return self._rc

    def die(self, rc=-9):
        """SIGKILL equivalent: the server vanishes, the exit code shows
        up at the next supervisor poll."""
        self.server.stop()
        self._rc = rc

    def terminate(self):
        self.server.stop()  # ModelServer.stop == graceful drain
        self._rc = 0

    def kill(self):
        self.die(-9)

    def wait(self, timeout=None):
        return self._rc if self._rc is not None else 0


# -- retry budget ------------------------------------------------------------

def test_retry_budget_min_tokens_and_window():
    clk = _FakeClock()
    b = RetryBudget(ratio=0.1, min_tokens=2, window_s=10.0, clock=clk)
    # no traffic at all: the floor still allows min_tokens spends
    assert b.try_spend() and b.try_spend()
    assert not b.try_spend()
    assert b.stats()["exhausted_total"] == 1
    # the window slides: old spends age out and tokens come back
    clk.t += 11.0
    assert b.remaining() == 2.0
    assert b.try_spend()


def test_retry_budget_ratio_scales_with_traffic():
    clk = _FakeClock()
    b = RetryBudget(ratio=0.1, min_tokens=1, window_s=10.0, clock=clk)
    for _ in range(100):
        b.note_request()
    # 10% of 100 requests = 10 tokens
    assert b.remaining() == 10.0
    for _ in range(10):
        assert b.try_spend()
    assert not b.try_spend()
    st = b.stats()
    assert st["requests_in_window"] == 100
    assert st["spent_in_window"] == 10
    assert st["remaining"] == 0.0


# -- mutable rotation --------------------------------------------------------

def test_router_add_remove_replica_rotation_safe():
    servers, router = _start_fleet(n=1)
    extra = _net(seed=0).serve(max_delay_ms=1.0)
    try:
        assert router.healthy_count() == 1
        rep = router.add_replica(extra.url)
        assert rep.ready and router.healthy_count() == 2
        for i in range(4):
            code, _ = _http(router.url + "/v1/predict",
                            {"features": _x(1, seed=i).tolist()})
            assert code == 200
        router.poll_once()
        per = [r["stats"]["requests"] if r["stats"] else 0
               for r in router.stats()["replicas"]]
        assert all(n >= 1 for n in per), per  # both replicas served
        # removal is by URL and immediate; traffic keeps flowing
        assert router.remove_replica(servers[0].url) is not None
        assert len(router.replicas) == 1
        for i in range(2):
            code, _ = _http(router.url + "/v1/predict",
                            {"features": _x(1, seed=i).tolist()})
            assert code == 200
        assert router.remove_replica("http://127.0.0.1:1/none") is None
    finally:
        _stop_all(router, servers)
        extra.stop()


# -- hedging + budget --------------------------------------------------------

def test_hedge_fires_on_slow_replica_and_wins():
    servers, router = _start_fleet(n=2, hedge=True, hedge_floor_ms=20.0,
                                   hedge_ceil_ms=120.0)
    try:
        # first proxy attempt (the primary) stalls well past the hedge
        # delay; the hedge lands on the sibling and answers first
        faults.arm("router.proxy", "delay", delay_s=1.0)
        t0 = time.monotonic()
        code, body = _http(router.url + "/v1/predict",
                           {"features": _x(1).tolist()})
        elapsed = time.monotonic() - t0
        assert code == 200, body
        assert elapsed < 0.9, elapsed  # did NOT wait out the slow primary
        st = router.stats()
        assert st["hedges"] == 1
        assert st["hedge_wins"] == 1
        assert st["retry_budget"]["spent_total"] == 1  # the hedge paid
    finally:
        _stop_all(router, servers)


def test_hedge_respects_exhausted_budget():
    servers, router = _start_fleet(n=2, hedge=True, hedge_floor_ms=20.0,
                                   hedge_ceil_ms=60.0,
                                   retry_budget_ratio=0.0,
                                   retry_budget_min=0)
    try:
        faults.arm("router.proxy", "delay", delay_s=0.4)
        t0 = time.monotonic()
        code, _ = _http(router.url + "/v1/predict",
                        {"features": _x(1).tolist()})
        elapsed = time.monotonic() - t0
        # no token -> no hedge: the request rides out the slow primary
        assert code == 200
        assert elapsed >= 0.4
        st = router.stats()
        assert st["hedges"] == 0
        assert st["retry_budget"]["exhausted_total"] >= 1
    finally:
        _stop_all(router, servers)


def test_budget_exhaustion_degrades_to_single_attempt():
    """A dead replica still in rotation + zero budget: requests that
    draw the corpse get its 502 back (clean, single-attempt, no storm);
    requests that draw the live replica succeed — and the router's
    counters reconcile exactly with what the client saw."""
    servers, router = _start_fleet(n=2, retry_budget_ratio=0.0,
                                   retry_budget_min=0)
    try:
        router.poll_once()
        servers[0].stop()  # dead, but NOT re-polled: stays in rotation
        codes = []
        for i in range(4):
            code, _ = _http(router.url + "/v1/predict",
                            {"features": _x(1, seed=i).tolist()})
            codes.append(code)
        # round-robin alternates primaries: half hit the corpse
        assert sorted(codes) == [200, 200, 502, 502]
        st = router.stats()
        assert st["retries"] == 0                  # budget never allowed one
        assert st["unroutable"] == 2               # == client-observed 5xx
        assert st["retry_budget"]["exhausted_total"] == 2
        ok = sum(p["latency_hist_s"]["count"]
                 for p in st["priorities"].values())
        total = sum(p["requests"] for p in st["priorities"].values())
        assert ok == 2 and total == 4              # ok + unroutable == total
    finally:
        _stop_all(router, servers)


def test_default_budget_allows_failover_retry():
    servers, router = _start_fleet(n=2)
    try:
        router.poll_once()
        servers[0].stop()
        for i in range(4):
            code, body = _http(router.url + "/v1/predict",
                               {"features": _x(1, seed=i).tolist()})
            assert code == 200, body  # fail-over retry absorbed the corpse
        st = router.stats()
        assert st["retries"] >= 1
        assert st["unroutable"] == 0
    finally:
        _stop_all(router, servers)


# -- staleness ----------------------------------------------------------------

def test_stale_replica_excluded_from_fleet_aggregates():
    servers, router = _start_fleet(n=2, stats_staleness_s=0.25)
    try:
        for i in range(4):
            code, _ = _http(router.url + "/v1/predict",
                            {"features": _x(1, seed=i).tolist()})
            assert code == 200
        router.poll_once()
        st = router.stats()
        total_rows = st["rows_by_policy"]["f32"]
        assert total_rows == 4
        assert all(not r["stale"] for r in st["replicas"])
        servers[0].stop()
        time.sleep(0.3)        # replica 0's last good poll ages past bound
        router.poll_once()     # refreshes replica 1, fails on replica 0
        st = router.stats()
        by_idx = {r["index"]: r for r in st["replicas"]}
        assert by_idx[0]["stale"] is True
        assert by_idx[0]["last_ok_poll_age_s"] > 0.25
        assert by_idx[1]["stale"] is False
        # the dead replica's cached rows are history, not fleet state
        assert st["rows_by_policy"]["f32"] == (
            by_idx[1]["stats"]["rows"])
        assert st["rows_by_policy"]["f32"] < total_rows
        # ...and its serving families are gone from the /metrics page,
        # while the staleness age itself IS exported
        parsed = parse_prometheus_text(router_metrics(st))
        reps = {dict(lbl).get("replica")
                for lbl in parsed["dl4j_serving_rows_total"]}
        assert reps == {"1"}
        ages = {dict(lbl)["replica"]: v for lbl, v in
                parsed["dl4j_router_replica_stats_age_seconds"].items()}
        assert ages["0"] > 0.25
    finally:
        _stop_all(router, servers)


# -- concurrent polling -------------------------------------------------------

def test_concurrent_poll_is_not_serialized_by_a_wedged_replica():
    servers, router = _start_fleet(n=3)
    try:
        servers[2].stop()  # one dead sibling that must still get ejected
        # EVERY poll hangs 0.5s (router.poll fires once per replica):
        # serial polling would cost >= 3 x 0.5s, concurrent ~0.5s
        faults.arm("router.poll", "delay", delay_s=0.5, times=99)
        t0 = time.monotonic()
        healthy = router.poll_once()
        elapsed = time.monotonic() - t0
        assert elapsed < 1.2, f"polls serialized: {elapsed:.2f}s"
        assert healthy == 2  # the wedge did not mask the dead sibling
        assert faults.hits("router.poll") >= 3
    finally:
        _stop_all(router, servers)


def test_poll_raise_counts_as_unready():
    servers, router = _start_fleet(n=1)
    try:
        assert router.poll_once() == 1
        faults.arm("router.poll", "raise")
        assert router.poll_once() == 0   # injected failure = not ready
        assert router.poll_once() == 1   # one-shot plan: recovers after
    finally:
        _stop_all(router, servers)


# -- supervision --------------------------------------------------------------

def _fleet_with_supervisor(n=2, **kw):
    handles = [_Handle() for _ in range(n)]
    router = Router([h.url for h in handles],
                    poll_interval_s=3600.0).start()
    kw.setdefault("backoff_fn", lambda attempt: 0.0)
    sup = FleetSupervisor(spawn_fn=_Handle, router=router, initial=handles,
                          min_replicas=n, max_replicas=n, **kw)
    # not started: tests call tick() by hand for determinism
    return handles, router, sup


def test_supervisor_reaps_and_respawns_with_rereg():
    handles, router, sup = _fleet_with_supervisor(n=2)
    try:
        handles[0].die(rc=-9)
        sup.tick()                       # reap: out of rotation, backoff@0
        assert len(router.replicas) == 1
        st = sup.stats()
        assert st["states"]["running"] == 1
        sup.tick()                       # respawn due: new URL registered
        assert len(router.replicas) == 2
        assert router.poll_once() == 2
        st = sup.stats()
        assert st["restarts_total"] == 1
        assert st["states"]["running"] == 2
        # the healed slot re-registered its NEW ephemeral-port URL
        respawned = [s for s in st["slots"] if s["restarts"] == 1]
        assert respawned and router.find_replica(
            respawned[0]["url"]) is not None
        # traffic lands on the healed fleet
        for i in range(4):
            code, _ = _http(router.url + "/v1/predict",
                            {"features": _x(1, seed=i).tolist()})
            assert code == 200
    finally:
        sup.stop()
        router.stop()
        for h in sup.handles():
            h.terminate()


def test_supervisor_quarantines_crash_loop_then_probes():
    handles, router, sup = _fleet_with_supervisor(
        n=1, max_restarts=2, restart_window_s=100.0, quarantine_s=0.15)
    try:
        # every respawn fails at the spawn fault point: a deterministic
        # crash-loop. death 1 -> backoff; failed spawn = death 2 ->
        # quarantined (2 deaths in window), NOT hot-looped.
        faults.arm("supervisor.spawn", "raise", times=1)
        handles[0].die(rc=1)
        sup.tick()                       # reap -> backoff(0)
        sup.tick()                       # respawn attempt fails
        st = sup.stats()
        assert st["spawn_failures_total"] == 1
        assert st["states"]["quarantined"] == 1
        assert st["quarantines_total"] == 1
        sup.tick()                       # quarantine holds: no spawn yet
        assert sup.stats()["states"]["quarantined"] == 1
        time.sleep(0.2)                  # quarantine elapses
        sup.tick()                       # probe respawn (fault disarmed)
        st = sup.stats()
        assert st["states"]["running"] == 1
        assert st["restarts_total"] == 1
        assert router.poll_once() == 1
    finally:
        sup.stop()
        router.stop()
        for h in sup.handles():
            h.terminate()


def test_scale_down_drains_without_dropping_requests():
    handles, router, sup = _fleet_with_supervisor(n=2)
    sup.min_replicas = 1
    results = {"codes": [], "errors": 0}
    stop_load = threading.Event()

    def loader():
        i = 0
        while not stop_load.is_set():
            try:
                code, _ = _http(router.url + "/v1/predict",
                                {"features": _x(1, seed=i).tolist()},
                                timeout=10)
                results["codes"].append(code)
            except Exception:
                results["errors"] += 1
            i += 1

    threads = [threading.Thread(target=loader) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)                  # load in flight
        assert sup.scale_down() is True  # drain-then-stop the emptiest
        time.sleep(0.2)                  # load continues on the survivor
        stop_load.set()
        for t in threads:
            t.join(timeout=15.0)
        assert results["errors"] == 0
        assert results["codes"] and all(c == 200 for c in results["codes"])
        st = sup.stats()
        assert st["states"]["running"] == 1
        assert st["states"]["stopped"] == 1
        assert sup.scale_down() is False  # refuses below min_replicas
    finally:
        stop_load.set()
        sup.stop()
        router.stop()
        for h in sup.handles():
            h.terminate()


def test_scale_up_bounded_by_max():
    handles, router, sup = _fleet_with_supervisor(n=1)
    sup.max_replicas = 2
    try:
        assert sup.scale_up() is True
        assert len(router.replicas) == 2
        assert sup.stats()["states"]["running"] == 2
        assert sup.scale_up() is False   # at max
    finally:
        sup.stop()
        router.stop()
        for h in sup.handles():
            h.terminate()


# -- autoscaler ---------------------------------------------------------------

class _SupProbe:
    def __init__(self):
        self.min_replicas, self.max_replicas = 1, 4
        self.ups = 0
        self.downs = 0
        self.running = 2

    def scale_up(self):
        self.ups += 1
        self.running += 1
        return True

    def scale_down(self):
        self.downs += 1
        self.running -= 1
        return True

    def running_count(self):
        return self.running


class _RepProbe:
    def __init__(self, queue_depth=0, p99=10.0, breaker="closed",
                 degraded=0):
        self.ready = True
        self._st = {"priorities": {"interactive":
                                   {"queue_depth": queue_depth}},
                    "latency_ms": {"p99": p99},
                    "degraded_batches": degraded,
                    "breaker": {"state": breaker}}

    def stale(self, s):
        return False

    @property
    def last_stats(self):
        return self._st


class _RouterProbe:
    stats_staleness_s = 10.0

    def __init__(self, reps):
        self.replicas = reps


def test_autoscaler_hysteresis_and_cooldown():
    clk = _FakeClock()
    sup = _SupProbe()
    hot = _RouterProbe([_RepProbe(queue_depth=100), _RepProbe()])
    a = Autoscaler(hot, sup, slo_p99_ms=500.0, consecutive=3,
                   cooldown_s=30.0, clock=clk)
    # one spiky evaluation does nothing; the streak must persist
    assert a.evaluate_once() == "hold"
    assert a.evaluate_once() == "hold"
    assert a.evaluate_once() == "scale_up"
    assert sup.ups == 1
    # cooldown: the same raw signal cannot act again yet
    for _ in range(5):
        assert a.evaluate_once() == "hold"
    assert sup.ups == 1
    clk.t += 31.0                       # cooldown over; streak rebuilds
    assert a.evaluate_once() == "hold"
    assert a.evaluate_once() == "hold"
    assert a.evaluate_once() == "scale_up"
    assert sup.ups == 2
    st = a.stats()
    assert st["decisions"]["scale_up"] == 2
    assert st["signals"]["queue_depth"] == 100


def test_autoscaler_scales_down_idle_fleet_and_p99_breach_up():
    clk = _FakeClock()
    sup = _SupProbe()
    idle = _RouterProbe([_RepProbe(queue_depth=0, p99=5.0),
                         _RepProbe(queue_depth=0, p99=5.0)])
    a = Autoscaler(idle, sup, slo_p99_ms=500.0, consecutive=2,
                   cooldown_s=0.0, clock=clk)
    assert a.evaluate_once() == "hold"
    assert a.evaluate_once() == "scale_down"
    assert sup.downs == 1
    # p99 over the SLO is an up signal even with empty queues
    slow = _RouterProbe([_RepProbe(queue_depth=0, p99=900.0)])
    a2 = Autoscaler(slow, sup, slo_p99_ms=500.0, consecutive=1,
                    cooldown_s=0.0, clock=clk)
    assert a2.evaluate_once() == "scale_up"


class _PartSupProbe(_SupProbe):
    """Supervisor probe that also reports partitioned slots."""

    def __init__(self, partitioned=1):
        super().__init__()
        self.partitioned = partitioned

    def stats(self):
        return {"states": {"partitioned": self.partitioned}}


def test_autoscaler_holds_partitioned_capacity():
    clk = _FakeClock()
    sup = _PartSupProbe(partitioned=1)
    hot = _RouterProbe([_RepProbe(queue_depth=100), _RepProbe()])
    a = Autoscaler(hot, sup, slo_p99_ms=500.0, consecutive=2,
                   cooldown_s=30.0, clock=clk)
    assert a.evaluate_once() == "hold"            # streak building
    # streak satisfied, but partitioned capacity still exists on the far
    # side of the partition: the scale-up is REFUSED, not just delayed
    assert a.evaluate_once() == "hold_partitioned"
    assert sup.ups == 0
    # no cooldown was taken — the moment the partition resolves, the
    # already-built streak acts immediately
    sup.partitioned = 0
    assert a.evaluate_once() == "scale_up"
    assert sup.ups == 1
    assert a.stats()["decisions"]["hold_partitioned"] == 1


# -- replica agent: the per-host control plane ---------------------------------

def _start_agents(n_agents=1, max_replicas=4):
    """In-process agents whose spawn_fn makes real in-process replicas
    (`_Handle` wraps a warmed `ModelServer`); returns (agents, spawned)."""
    spawned = []

    def spawn_fn(argv):
        assert argv and argv[0] == "serve"
        h = _Handle()
        spawned.append(h)
        return h

    agents = [ReplicaAgent(spawn_fn, max_replicas=max_replicas).start()
              for _ in range(n_agents)]
    return agents, spawned


def _stop_agents(agents):
    for a in agents:
        a.stop(terminate_children=True, drain_timeout_s=5.0)


def test_agent_control_plane_spawn_stop_and_clean_errors():
    agents, spawned = _start_agents(max_replicas=1)
    agent = agents[0]
    try:
        client = AgentClient(agent.url, timeout_s=5.0)
        h = client.spawn(["serve"])
        assert h.url and h.poll() is None
        assert h.wait_ready()["url"] == h.url
        assert agent.health()["replicas"] == 1
        # capacity bound: the agent is a bounded nursery, not a fork bomb
        with pytest.raises(RuntimeError, match="409"):
            client.spawn(["serve"])
        # only `serve` argv is accepted — the agent is not a remote shell
        code, text = _http(agent.url + "/a/spawn", {"argv": ["rm", "-rf"]})
        assert code == 400 and "error" in json.loads(text)
        # malformed JSON body -> clean 400, not a handler crash
        req = urllib.request.Request(
            agent.url + "/a/spawn", data=b"{not json",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        # unknown replica id -> 404
        code, _ = _http(agent.url + "/a/stop", {"id": 99})
        assert code == 404
        # unknown path -> 404 JSON
        code, text = _http(agent.url + "/a/nope")
        assert code == 404 and "error" in json.loads(text)
        # graceful stop reports the drained exit code; the snapshot and
        # the remote handle's poll() see it
        out = client.stop(h.rid, wait=True)
        assert out["exit_code"] == 0
        assert h.poll() == 0
        recs = client.refresh()
        assert [r["alive"] for r in recs] == [False]
        assert agent.health()["replicas"] == 0
        # a vacated slot frees capacity again
        h2 = client.spawn(["serve"])
        assert h2.rid != h.rid
        assert agent.health()["spawns_total"] == 2
    finally:
        _stop_agents(agents)


def test_agent_serves_cache_entries_with_counters(tmp_path):
    (tmp_path / "deadbeef.ptp").write_bytes(b"ptp-bytes")
    agent = ReplicaAgent(lambda argv: _Handle(), cache_dir=str(tmp_path),
                         max_replicas=1).start()
    try:
        code, text = _http(agent.url + "/a/cache/deadbeef.ptp")
        assert code == 200 and text == "ptp-bytes"
        code, _ = _http(agent.url + "/a/cache/cafecafe.ptp")   # absent
        assert code == 404
        code, _ = _http(agent.url + "/a/cache/..%2Fetc%2Fpasswd")
        assert code == 404                                      # bad name
        h = agent.health()
        assert h["cache_requests_total"] == 3
        assert h["cache_hits_total"] == 1
    finally:
        agent.stop()


# -- lease-based remote supervision ------------------------------------------

def _remote_fleet(client, handle, **kw):
    router = Router([handle.url], poll_interval_s=3600.0).start()
    kw.setdefault("backoff_fn", lambda attempt: 0.0)
    sup = FleetSupervisor(spawn_fn=None, router=router, initial=[handle],
                          min_replicas=1, max_replicas=1,
                          agents=[client] if not isinstance(client, list)
                          else client,
                          remote_argv=["serve"], **kw)
    return router, sup


def test_remote_replica_death_respawns_through_agent():
    agents, spawned = _start_agents()
    agent = agents[0]
    router = sup = None
    try:
        client = AgentClient(agent.url, timeout_s=5.0)
        h = client.spawn(["serve"])
        router, sup = _remote_fleet(client, h)
        spawned[0].die(rc=-9)
        sup.tick()        # heartbeat refreshes the snapshot; reap
        st = sup.stats()
        assert st["states"]["backoff"] == 1
        assert st["slots"][0]["last_exit"] == -9
        assert len(router.replicas) == 0
        sup.tick()        # respawn goes THROUGH the agent
        st = sup.stats()
        assert st["states"]["running"] == 1
        assert st["restarts_total"] == 1
        assert st["slots"][0]["agent"] == client.url
        assert agent.health()["spawns_total"] == 2
        assert len(router.replicas) == 1
    finally:
        if sup:
            sup.stop()
        if router:
            router.stop()
        _stop_agents(agents)


def test_lease_partition_holds_slots_then_heal_adopts_no_double_spawn():
    agents, spawned = _start_agents()
    agent = agents[0]
    router = sup = None
    try:
        client = AgentClient(agent.url, timeout_s=5.0)
        h = client.spawn(["serve"])
        router, sup = _remote_fleet(client, h, lease_misses=2,
                                    agent_failover_s=1e9)
        sup.tick()                              # healthy lease
        assert sup.stats()["states"]["running"] == 1
        faults.arm("agent.partition", "raise", times=3)
        sup.tick()                              # miss 1: lease holds
        assert sup.stats()["states"]["running"] == 1
        sup.tick()                              # miss 2: partitioned
        st = sup.stats()
        assert st["states"]["partitioned"] == 1
        assert st["partitions_total"] == 1
        assert len(router.replicas) == 0        # out of rotation...
        sup.tick()                              # miss 3: held, no respawn
        assert sup.stats()["states"]["partitioned"] == 1
        assert agent.health()["spawns_total"] == 1   # ...but NOT respawned
        sup.tick()                              # plan exhausted: heal
        st = sup.stats()
        assert st["states"]["running"] == 1
        assert st["adopted_total"] == 1
        assert len(router.replicas) == 1
        # zero double-spawns: reconcile ADOPTED the live replica
        assert agent.health()["spawns_total"] == 1
        assert agent.health()["replicas"] == 1
        ag = st["agents"][0]
        assert ag["state"] == "leased" and ag["reconciles_total"] == 1
    finally:
        if sup:
            sup.stop()
        if router:
            router.stop()
        _stop_agents(agents)


class _FlakyClient(AgentClient):
    """AgentClient whose heartbeat can be switched off: a partition
    between supervisor and ONE healthy agent, injected per-client."""

    offline = False

    def refresh(self):
        if self.offline:
            raise OSError("injected partition")
        return super().refresh()


def test_partition_failover_lands_on_survivor_then_heal_stops_orphan():
    agents, spawned = _start_agents(n_agents=2)
    a0, a1 = agents
    router = sup = None
    try:
        clients = [_FlakyClient(a.url, timeout_s=5.0) for a in agents]
        clk = _FakeClock()
        h = clients[0].spawn(["serve"])
        router, sup = _remote_fleet(clients, h, lease_misses=1,
                                    agent_failover_s=30.0, clock=clk)
        clients[0].offline = True
        sup.tick()                      # 1 miss -> partitioned, held
        assert sup.stats()["states"]["partitioned"] == 1
        assert len(router.replicas) == 0
        assert a1.health()["spawns_total"] == 0
        clk.t += 31.0
        sup.tick()                      # past failover: respawn on survivor
        st = sup.stats()
        assert st["states"]["running"] == 1
        assert st["failovers_total"] == 1
        assert st["slots"][0]["agent"] == clients[1].url
        assert a1.health()["spawns_total"] == 1
        assert len(router.replicas) == 1
        # partition heals: the old child on agent0 is no longer intended
        # (its slot failed over) — reconcile stops the orphan
        clients[0].offline = False
        sup.tick()
        st = sup.stats()
        ag0 = next(a for a in st["agents"] if a["url"] == clients[0].url)
        assert ag0["state"] == "leased"
        assert ag0["orphans_stopped_total"] == 1
        assert a0.health()["replicas"] == 0
        # intent stayed at one replica: exactly one spawn per agent, ever
        assert a0.health()["spawns_total"] == 1
        assert a1.health()["spawns_total"] == 1
        assert st["states"]["running"] == 1
    finally:
        if sup:
            sup.stop()
        if router:
            router.stop()
        _stop_agents(agents)


# -- failure-domain-aware hedging ---------------------------------------------

def test_hedge_and_retry_prefer_a_different_host():
    r1 = Router.__new__(Router)  # only _prefer_other_hosts is exercised
    mk = lambda host: type("R", (), {"host": host})()  # noqa: E731
    a, b, c, d = mk("h1"), mk("h1"), mk("h2"), mk("h2")
    # tail reordered: different-host replicas first, same-host last
    out = Router._prefer_other_hosts([a, b, c, d])
    assert [r.host for r in out] == ["h1", "h2", "h2", "h1"]
    # single-host fleet (or a 2-replica rotation): untouched
    assert Router._prefer_other_hosts([a, b]) == [a, b]
    same = [mk("h1"), mk("h1"), mk("h1")]
    assert Router._prefer_other_hosts(same) == same
    assert r1 is not None


def test_hedge_under_half_open_breaker_counts_probe_outcome_once():
    """Satellite 4: a hedge fired while the primary's breaker is
    HALF_OPEN must count the probe outcome exactly once — the hedge's
    outcome lands on the hedge replica's breaker, the slow probe's own
    success lands on the primary's, and neither double-transitions."""
    servers, router = _start_fleet(n=2, hedge=True, hedge_floor_ms=1.0,
                                   hedge_ceil_ms=50.0)
    try:
        assert router.poll_once() == 2
        primary = router.replicas[0]
        primary.breaker = CircuitBreaker(failure_threshold=3,
                                         reset_timeout_s=0.0,
                                         probe_prob=1.0)
        for _ in range(3):
            primary.breaker.record_failure()
        # reset_timeout 0: tripped, and already reporting HALF_OPEN
        assert primary.breaker.stats()["state"] == "half_open"
        assert primary.breaker.stats()["opens"] == 1
        # reset_timeout 0 + probe_prob 1: the next allow() is a half-open
        # probe, so the primary re-enters rotation exactly as a probe
        faults.arm("router.proxy", "delay", delay_s=0.4, nth=1, times=1)
        code, text = _http(router.url + "/v1/predict",
                           {"features": _x(1, seed=5).tolist()}, timeout=30)
        assert code == 200          # the hedge answered while the probe ran
        st = router.stats()
        assert st["hedges"] == 1 and st["hedge_wins"] == 1
        # the delayed probe eventually completes against its replica
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            bs = primary.breaker.stats()
            if bs["successes"] == 1:
                break
            time.sleep(0.02)
        bs = primary.breaker.stats()
        assert bs["successes"] == 1      # counted exactly once
        assert bs["state"] == "closed"   # probe success closes it...
        assert bs["opens"] == 1          # ...with no second transition
    finally:
        _stop_all(router, servers)


# -- Prometheus conformance ---------------------------------------------------

def test_new_metric_families_parse_and_stay_monotonic():
    handles, router, sup = _fleet_with_supervisor(n=2)
    a = Autoscaler(router, sup, clock=time.monotonic)
    router.attach_fleet(sup, a)
    try:
        a.evaluate_once()
        text1 = router_metrics(router.stats())
        parsed1 = parse_prometheus_text(text1)  # strict: raises on junk
        for fam in ("dl4j_router_hedges_total",
                    "dl4j_router_hedge_wins_total",
                    "dl4j_router_retry_budget_remaining",
                    "dl4j_router_retry_budget_exhausted_total",
                    "dl4j_fleet_restarts_total",
                    "dl4j_fleet_spawn_failures_total"):
            assert fam in parsed1, fam
        states = {dict(lbl)["state"]
                  for lbl in parsed1["dl4j_fleet_replicas"]}
        assert {"running", "backoff", "quarantined", "stopped"} <= states
        assert parsed1["dl4j_fleet_replicas"][(("state", "running"),)] == 2
        decisions = {dict(lbl)["decision"]
                     for lbl in parsed1["dl4j_autoscaler_decisions_total"]}
        assert decisions == {"scale_up", "scale_down", "hold",
                             "hold_partitioned"}
        assert "dl4j_autoscaler_target_replicas" in parsed1
        # traffic + a restart move the counters the right way only
        for i in range(2):
            _http(router.url + "/v1/predict",
                  {"features": _x(1, seed=i).tolist()})
        handles[0].die()
        sup.tick()
        sup.tick()
        a.evaluate_once()
        parsed2 = parse_prometheus_text(router_metrics(router.stats()))
        for fam, series in parsed1.items():
            if not fam.endswith("_total"):
                continue
            for lbl, v1 in series.items():
                v2 = parsed2.get(fam, {}).get(lbl)
                if v2 is not None:
                    assert v2 >= v1, (fam, lbl, v1, v2)
        assert parsed2["dl4j_fleet_restarts_total"][()] == 1
    finally:
        sup.stop()
        router.stop()
        for h in sup.handles():
            h.terminate()




# -- the JAX modules on the same recorded inputs -------------------------------

def _jax_fleet():
    from deeplearning4j_tpu.reliability import RetryBudget as JBudget
    from deeplearning4j_tpu.serving.autoscaler import Autoscaler as JAuto
    from deeplearning4j_tpu.serving.router import Router as JRouter
    return JBudget, JAuto, JRouter


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retry_budget_token_sequence_equals_jaxs(seed):
    """A recorded sequence of requests, spends and clock moves: every
    answer, remaining count and stats block is the JAX budget's."""
    JBudget, _, _ = _jax_fleet()
    rng = np.random.RandomState(seed)
    ops = [("req", "spend", "tick")[i] for i in rng.choice(
        3, size=400, p=[0.5, 0.35, 0.15])]
    steps = rng.uniform(0.0, 4.0, size=len(ops))
    trace = []
    for cls in (RetryBudget, JBudget):
        clk = _FakeClock()
        b = cls(ratio=0.1 * (seed + 1), min_tokens=seed + 1, window_s=10.0,
                clock=clk)
        out = []
        for op, dt in zip(ops, steps):
            if op == "req":
                b.note_request()
            elif op == "spend":
                out.append(b.try_spend())
            else:
                clk.t += float(dt)
            out.append(b.remaining())
        out.append(b.stats())
        trace.append(out)
    assert trace[0] == trace[1]


def _recorded_signals(seed, n=40):
    """A recorded sequence of fleet states: per evaluation, each replica's
    queue depth, p99 ms, breaker state and degraded batches, and the
    partitioned slots."""
    rng = np.random.RandomState(seed)
    seq = []
    for _ in range(n):
        reps = [(int(rng.choice([0, 0, 1, 4, 30, 120])),
                 float(rng.choice([3.0, 40.0, 260.0, 700.0])),
                 str(rng.choice(["closed", "closed", "open"])),
                 int(rng.choice([0, 0, 2])))
                for _ in range(int(rng.randint(1, 4)))]
        seq.append((reps, int(rng.choice([0, 0, 0, 1]))))
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_autoscaler_decisions_over_recorded_stats_equal_jaxs(seed):
    _, JAuto, _ = _jax_fleet()
    seq = _recorded_signals(seed)
    runs = []
    for cls in (Autoscaler, JAuto):
        clk = _FakeClock()
        sup = _PartSupProbe(partitioned=0)
        router = _RouterProbe([])
        a = cls(router, sup, slo_p99_ms=250.0, consecutive=2,
                cooldown_s=5.0, clock=clk)
        out = []
        for reps, part in seq:
            router.replicas = [_RepProbe(q, p, br, dg)
                               for q, p, br, dg in reps]
            sup.partitioned = part
            out.append(a.evaluate_once())
            clk.t += 2.0
        st = a.stats()
        st.pop("cooldown_remaining_s", None)
        out.append((st, sup.ups, sup.downs, sup.running))
        runs.append(out)
    assert runs[0] == runs[1]
    assert set(runs[0][:-1]) > {"hold"}


def test_router_rotation_after_add_and_remove_equals_jaxs():
    _, _, JRouter = _jax_fleet()
    urls = [f"http://127.0.0.1:{9000 + i}" for i in range(4)]
    plan = [("rot",), ("rot",), ("add", "http://127.0.0.1:9100"), ("rot",),
            ("remove", urls[1]), ("rot",), ("rot",), ("unready", 0),
            ("rot",), ("add", "http://127.0.0.1:9101"), ("rot",),
            ("remove", urls[0]), ("rot",), ("rot",), ("remove", "x"),
            ("rot",)]
    runs = []
    for cls in (Router, JRouter):
        r = cls(list(urls), poll_interval_s=3600.0)
        try:
            for rep in r.replicas:
                rep._ready = True
            out = []
            for step in plan:
                if step[0] == "rot":
                    out.append([x.url for x in r._rotation()])
                elif step[0] == "add":
                    rep = r.add_replica(step[1])
                    rep._ready = True
                    out.append(rep.index)
                elif step[0] == "remove":
                    gone = r.remove_replica(step[1])
                    out.append(None if gone is None else gone.index)
                else:
                    r.replicas[step[1]]._ready = False
            out.append([(x.index, x.url) for x in r.replicas])
            runs.append(out)
        finally:
            r.server.server_close()
    assert runs[0] == runs[1]


def test_answers_through_the_router_equal_the_single_process():
    net = _net()
    servers, router = _start_fleet(n=2)
    try:
        for i in range(6):
            x = _x(1 + i % 3, seed=10 + i)
            code, text = _http(router.url + "/v1/predict",
                               {"features": x.tolist()})
            assert code == 200, text
            np.testing.assert_array_equal(
                np.asarray(json.loads(text)["output"], np.float32),
                net.output(x).numpy())
        router.poll_once()
        per = [r["stats"]["requests"] for r in router.stats()["replicas"]]
        assert per == [3, 3]
    finally:
        _stop_all(router, servers)


# -- the store's entries over the cachesync wire ---------------------------------

def _table_store(tmp_path, entries):
    """A store holding a tuned table for the MLP on the CPU."""
    from deeplearning4j_tpu_torch.optimize.persist import \
        PersistentProgramStore

    store = PersistentProgramStore(str(tmp_path), device="cpu")
    fp = conf_fingerprint(mlp(n_in=N_IN, hidden=[8], n_out=N_OUT,
                              lr=0.05))
    tunables.save_table(store, tunables.TunedTable(
        entries, device_kind="cpu", fingerprint=fp))
    return store


def test_cold_store_gets_the_table_over_the_wire_and_a_corrupt_fetch_is_counted(
        tmp_path):
    _table_store(tmp_path / "warm", {"batcher.target_rows": 128,
                                     "decode.slots": 2})
    server = CacheServer(str(tmp_path / "warm")).start()
    try:
        cold = MultiLayerNetwork(mlp(n_in=N_IN, hidden=[8], n_out=N_OUT,
                                     lr=0.05), device="cpu", seed=0).init()
        store = cold.set_compile_cache(
            str(tmp_path / "cold"),
            remote=CacheFetcher([server.url], timeout_s=5.0))
        assert store.fetch_hits == 1 and store.fetch_corrupt == 0
        assert tunables.status()["source"] == "disk"
        assert tunables.resolve("batcher.target_rows") == 128
        # served from memory, not written to the cold directory
        assert len(store) == 0
        tunables.clear()
        # a corrupted fetch: the checksum rejects it, counted, no table
        faults.arm("agent.cache_fetch", "corrupt", times=1)
        cold2 = MultiLayerNetwork(mlp(n_in=N_IN, hidden=[8], n_out=N_OUT,
                                      lr=0.05), device="cpu", seed=0).init()
        store2 = cold2.set_compile_cache(
            str(tmp_path / "cold2"),
            remote=CacheFetcher([server.url], timeout_s=5.0))
        assert store2.fetch_corrupt == 1 and store2.fetch_hits == 0
        assert tunables.active() is None
        assert tunables.resolve("batcher.target_rows") == 256
    finally:
        server.stop()


def test_cache_server_lists_and_serves_port_entries_only(tmp_path):
    from deeplearning4j_tpu_torch.serving import cachesync

    store = _table_store(tmp_path, {"decode.slots": 2})
    (tmp_path / "0123abcd.jxp").write_bytes(b"a JAX entry")
    names = cachesync.list_entries(str(tmp_path))
    assert len(names) == 1 and names[0].endswith(".ptp")
    server = CacheServer(str(tmp_path)).start()
    try:
        code, text = _http(server.url + "/a/cache")
        assert code == 200 and json.loads(text)["entries"] == names
        code, _ = _http(server.url + "/a/cache/0123abcd.jxp")
        assert code == 404
        with urllib.request.urlopen(server.url + "/a/cache/" + names[0],
                                    timeout=10) as r:
            raw = r.read()
        assert raw == open(os.path.join(str(tmp_path), names[0]),
                           "rb").read()
        assert len(store) == 1
    finally:
        server.stop()


# -- the CLI: serve --replicas and agent ------------------------------------------

def _ckpt_and_table(tmp_path):
    """The MLP's checkpoint, a store holding its tuned table, and the
    single process's answers to the requests the tests send."""
    net = _net()
    ckpt = str(tmp_path / "model")
    checkpoint.save(ckpt, net.params, conf=net.conf)
    cache = str(tmp_path / "cache")
    _table_store(cache, {"batcher.max_delay_ms": 2.0,
                         "decode.slots": 2})
    x = _x(2, seed=1)
    return ckpt, cache, x, net.output(x).numpy()


def _start_cli(args, env=None, timeout=120.0):
    p = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env or dict(os.environ, PYTHONPATH=ROOT))
    watchdog = threading.Timer(timeout, p.kill)
    watchdog.start()
    try:
        line = p.stdout.readline()
    finally:
        watchdog.cancel()
    assert line, p.stderr.read()[-3000:]
    return p, json.loads(line)


def test_cli_fleet_sigkill_heals_with_the_table_and_clean_answers(tmp_path):
    """`serve --replicas 2 --hedge` on a store holding the tuned table:
    both replicas inherit it (fresh_tunes 0); SIGKILL one under load ->
    every answer bitwise the single process's or a clean 5xx, the
    supervisor respawns it (the respawn inherits the table too), the
    router's counters reconcile with what the clients saw, SIGTERM drains
    to exit 0. Each replica captures (on the CPU: makes) its warmed
    programs at start: `fresh_compiles` is the warmed shapes' count."""
    ckpt, cache, x, expected = _ckpt_and_table(tmp_path)
    proc, summary = _start_cli(
        ["serve", "--model", ckpt, "--compile-cache", cache, "--shapes",
         "1,2", "--replicas", "2", "--min-replicas", "2",
         "--max-replicas", "2", "--hedge", "--port", "0",
         "--drain-timeout", "10", "--device", "cpu"])
    try:
        url = summary["url"]
        assert summary["fresh_compiles"] == [2, 2]
        assert summary["hedge"] is True
        assert all(t["tuned_tables"] == 1 and t["fresh_tunes"] == 0
                   and t["source"] == "disk" and t["device_kind"] == "cpu"
                   for t in summary["tuning"]), summary["tuning"]
        victim = summary["replica_pids"][0]
        outcomes = {"ok": 0, "err5xx": 0, "bad": []}
        lock = threading.Lock()
        stop = threading.Event()

        def client():
            body = {"features": x.tolist()}
            while not stop.is_set():
                try:
                    code, text = _http(url + "/v1/predict", body,
                                       timeout=30)
                except Exception as e:  # noqa: BLE001 - transport drop
                    with lock:
                        outcomes["bad"].append(f"transport: {e}")
                    continue
                if code == 200:
                    out = np.asarray(json.loads(text)["output"],
                                     np.float32)
                    with lock:
                        if np.array_equal(out, expected):
                            outcomes["ok"] += 1
                        else:
                            outcomes["bad"].append("wrong output")
                elif 500 <= code < 600:
                    json.loads(text)
                    with lock:
                        outcomes["err5xx"] += 1
                else:
                    with lock:
                        outcomes["bad"].append(f"code {code}")

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        os.kill(victim, signal.SIGKILL)
        healed = None
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            try:
                code, text = _http(url + "/v1/stats", timeout=10)
                st = json.loads(text)
            except Exception:  # noqa: BLE001
                time.sleep(0.2)
                continue
            fleet = st.get("fleet", {})
            if (st.get("healthy_replicas", 0) >= 2
                    and fleet.get("restarts_total", 0) >= 1):
                healed = st
                break
            time.sleep(0.2)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        assert healed is not None, "fleet never healed within 90s"
        respawned = [s for s in healed["fleet"]["slots"]
                     if s["restarts"] >= 1]
        assert respawned and all(s["fresh_compiles"] == 2
                                 for s in respawned), respawned
        for rep in healed["replicas"]:
            t = (rep.get("stats") or {}).get("tuning") or {}
            assert t.get("tuned_tables") == 1 and t.get("fresh_tunes") == 0
        assert outcomes["bad"] == [], outcomes["bad"][:5]
        assert outcomes["ok"] > 0
        code, text = _http(url + "/v1/stats", timeout=10)
        st = json.loads(text)
        ok_count = sum(p["latency_hist_s"]["count"]
                       for p in st["priorities"].values())
        total = sum(p["requests"] for p in st["priorities"].values())
        assert ok_count == outcomes["ok"]
        assert st["unroutable"] == outcomes["err5xx"]
        assert total == ok_count + st["unroutable"]
        # the router's /metrics and a replica's parse
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            fams = parse_prometheus_text(r.read().decode())
        assert fams["dl4j_fleet_restarts_total"][()] >= 1
        with urllib.request.urlopen(healed["replicas"][0]["url"]
                                    + "/metrics", timeout=10) as r:
            rfams = parse_prometheus_text(r.read().decode())
        assert rfams["dl4j_tuning_table_info"][
            (("device_kind", "cpu"),)] == 1

        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, (out, err)
        drained = json.loads(out.strip().splitlines()[-1])
        assert drained["drained"] is True and drained["restarts"] >= 1
        assert all(rc == 0 for rc in drained["replica_exit_codes"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_cli_agent_on_an_empty_store_gets_the_table_over_the_wire(
        tmp_path):
    """`agent` with an empty store; `serve --agent URL --compile-cache
    WARM` runs its cache server on WARM and spawns the replica through the
    agent with `--cache-from`: the replica inherits the table (fetched,
    fresh_tunes 0, a fetch hit), answers as the single process, and both
    drain to exit 0."""
    ckpt, cache, x, expected = _ckpt_and_table(tmp_path)
    agent, a_up = _start_cli(["agent", "--port", "0", "--compile-cache",
                              str(tmp_path / "empty"), "--max-replicas",
                              "1"])
    proc = None
    try:
        proc, summary = _start_cli(
            ["serve", "--model", ckpt, "--compile-cache", cache, "--shapes",
             "1,2", "--agent", a_up["url"], "--port", "0",
             "--drain-timeout", "10", "--device", "cpu"])
        assert summary["agents"] == [a_up["url"]]
        t = summary["tuning"][0]
        assert t["tuned_tables"] == 1 and t["fresh_tunes"] == 0
        assert t["source"] == "disk"
        code, text = _http(summary["url"] + "/v1/stats")
        slot = json.loads(text)["fleet"]["slots"][0]
        assert slot["agent"] == a_up["url"]
        assert slot["cache_fetch_hits"] >= 1
        code, text = _http(summary["url"] + "/v1/predict",
                           {"features": x.tolist()})
        assert code == 200
        np.testing.assert_array_equal(
            np.asarray(json.loads(text)["output"], np.float32), expected)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, (out, err)
        assert json.loads(out.strip().splitlines()[-1])["drained"]
        proc = None
        agent.send_signal(signal.SIGTERM)
        out, err = agent.communicate(timeout=60)
        assert agent.returncode == 0, (out, err)
        drained = json.loads(out.strip().splitlines()[-1])
        assert drained["spawns_total"] == 1
        assert not os.listdir(str(tmp_path / "empty"))
    finally:
        for p in (proc, agent):
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate()

"""Multi-replica serving front end: one URL over N `ModelServer`s.

The datacenter serving shape (Jouppi et al., 2017; Gemma-on-TPU in
PAPERS.md) is a replicated, load-balanced fleet: each replica owns its
chips and its coalescing queue, a thin front end spreads requests and
routes around bad replicas.  `Router` is that front end, deliberately
model-free — it never imports jax and holds no params, so one router
process stays cheap while the replicas do the device work:

  routing     POST /v1/predict is proxied to a healthy replica chosen
              round-robin; connection errors and 5xx "replica is gone"
              answers (502/503) fail over to the next replica within the
              same request, so a replica death mid-flight costs a retry,
              not an error.  Replica verdicts about the REQUEST
              (400 bad input, 504 deadline) pass through untouched.
  hedging     with `hedge=True`, a primary attempt that outlives a
              quantile-tracked delay (p95 of recent successful route
              latencies, clamped to [hedge_floor_ms, hedge_ceil_ms])
              gets a duplicate fired at the next routable replica; the
              first answer wins and the loser is abandoned (urllib has
              no cancel — the stray response is dropped on arrival).
  budget      every EXTRA attempt — fail-over retry or hedge — draws
              from a shared `RetryBudget` (default: 10% of the trailing
              request window, min-token floor).  A brown-out therefore
              degrades the fleet to single-attempt routing instead of
              amplifying into a retry storm.
  health      a background thread polls every replica's /readyz and
              /v1/stats CONCURRENTLY (one short-lived thread per
              replica), so one wedged replica cannot delay failure
              detection of its siblings.  An unready replica is ejected
              from rotation until it passes again.  Each replica also
              carries a `CircuitBreaker` fed by proxy outcomes —
              repeated failures eject it even between polls, half-open
              probes let it back.
  elasticity  the replica set is MUTABLE: `add_replica`/`remove_replica`
              swap a copy-on-write replica list under `_state_lock`, so
              the fleet supervisor can re-register a respawned replica's
              new ephemeral-port URL (and the autoscaler can grow/shrink
              the fleet) while requests are in flight — rotation always
              reads one consistent snapshot.
  staleness   a dead replica's last-polled stats are NOT re-exported as
              live fleet state: each replica stamps its last successful
              poll, `describe()` carries `last_ok_poll_age_s`, and
              replicas past `stats_staleness_s` are excluded from the
              fleet `rows_by_policy` aggregate and the /metrics
              re-export.
  priorities  the router parses each request's `priority` class for its
              own per-class accounting, then forwards the raw body —
              the replica's coalescing queue applies the actual
              preemption (serving/batcher.py).
  drain       `drain()` mirrors the replica SIGTERM contract: stop
              admitting (new predicts and readyz go 503), wait out
              in-flight proxies, close.  The CLI drains the router
              FIRST, then SIGTERMs the replicas, so every accepted
              request finds its replica still alive.
  metrics     GET /metrics exports the router's own counters plus every
              fresh replica's last-polled stats re-labeled {replica="i"}
              (serving/metrics.py) — one scrape sees the whole fleet,
              including the supervisor/autoscaler blocks when a fleet
              control plane is attached (`attach_fleet`).

Fault-injection points (reliability/faults.py): ``router.proxy`` fires
per proxy attempt (arm `raise` to fail it, `delay` to slow it — that is
what drives the hedging tests), ``router.poll`` fires per health poll
(arm `delay` to wedge one poll and prove the siblings still get
ejected promptly).

Replica processes share one warmed disk compile cache
(`optimize/persist.py` is multi-process-safe), so N replicas pay the
trace/compile cost zero times after one `warmup` — see the CLI's
`serve --replicas N`.

The port's own copy of `deeplearning4j_tpu/serving/router.py`. A replica
is a port `serve` process: it captures its CUDA graphs at start (a graph
is not kept on disk) and inherits the tuned table from the shared store.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.error import HTTPError, URLError
from urllib.parse import urlparse
from urllib.request import Request, urlopen

from deeplearning4j_tpu_torch.reliability import CircuitBreaker, RetryBudget, faults
from deeplearning4j_tpu_torch.serving.batcher import LATENCY_BUCKETS_S, PRIORITIES

#: replica answers that mean "this replica can't serve anyone right now"
#: (drain/overload) — retry the SAME request on a sibling
_RETRYABLE_CODES = (502, 503)


class Replica:
    """One backend `ModelServer` as the router sees it: URL, routing
    breaker, last-polled health and stats (plus when that poll last
    SUCCEEDED, so consumers can tell live state from a stale cache)."""

    def __init__(self, index: int, url: str,
                 breaker: Optional[CircuitBreaker] = None,
                 host: Optional[str] = None):
        self.index = int(index)
        self.url = url.rstrip("/")
        # failure-domain label: which HOST (agent) serves this replica.
        # Hedges/retries prefer a different host than the primary, and
        # breaker trips aggregate per host in the router stats.
        self.host = host or "local"
        # trips after a few consecutive proxy failures; short reset so a
        # restarted replica rejoins within a couple of poll intervals
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=3, reset_timeout_s=2.0)
        self._lock = threading.Lock()
        self._ready = False
        self._stats: Optional[dict] = None
        self._t_ok: Optional[float] = None  # last poll that SUCCEEDED

    @property
    def ready(self) -> bool:
        with self._lock:
            return self._ready

    @property
    def last_stats(self) -> Optional[dict]:
        with self._lock:
            return self._stats

    def last_ok_poll_age_s(self) -> Optional[float]:
        """Seconds since the last poll that found the replica ready
        (None = never); the staleness signal for fleet aggregates."""
        with self._lock:
            if self._t_ok is None:
                return None
            return time.monotonic() - self._t_ok

    def stale(self, staleness_s: float) -> bool:
        age = self.last_ok_poll_age_s()
        return age is None or age > staleness_s

    def routable(self) -> bool:
        """In rotation: passed the last /readyz poll AND the routing
        breaker admits traffic (closed, or a half-open probe)."""
        return self.ready and self.breaker.allow()

    def poll(self, timeout_s: float = 2.0) -> bool:
        """Refresh readiness (and, when ready, cached stats) from the
        replica; never raises.  Traverses the ``router.poll`` fault
        point — an armed `delay` simulates the wedged poll the
        concurrent poll loop must shrug off, an armed `raise` counts as
        an unready answer."""
        try:
            faults.fire("router.poll", replica=self.index)
            with urlopen(self.url + "/readyz", timeout=timeout_s) as r:
                ready = r.status == 200
        except Exception:  # noqa: BLE001 — any failure = not ready
            ready = False
        stats = None
        if ready:
            try:
                with urlopen(self.url + "/v1/stats", timeout=timeout_s) as r:
                    stats = json.loads(r.read().decode())
            except (URLError, HTTPError, OSError, ValueError):
                pass
        with self._lock:
            self._ready = ready
            if ready:
                self._t_ok = time.monotonic()
            if stats is not None:
                self._stats = stats
        return ready

    def describe(self, staleness_s: Optional[float] = None) -> dict:
        age = self.last_ok_poll_age_s()
        with self._lock:
            out = {
                "index": self.index,
                "url": self.url,
                "host": self.host,
                "healthy": self._ready,
                "last_ok_poll_age_s": (None if age is None
                                       else round(age, 3)),
                "breaker": self.breaker.stats(),
                "stats": self._stats,
            }
        if staleness_s is not None:
            out["stale"] = age is None or age > staleness_s
        return out


class _RouterHandler(BaseHTTPRequestHandler):
    router: "Router" = None

    def _send_json(self, body, code: int = 200) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        path = urlparse(self.path).path
        rt = self.router
        if path == "/v1/stats":
            self._send_json(rt.stats())
        elif path == "/metrics":
            from deeplearning4j_tpu_torch.serving.metrics import (CONTENT_TYPE,
                                                            router_metrics)
            data = router_metrics(rt.stats()).encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif path == "/healthz":
            self._send_json({"ok": True})
        elif path == "/readyz":
            if rt.is_ready():
                self._send_json({"ready": True,
                                 "replicas": rt.healthy_count()})
            else:
                self._send_json({"ready": False, "draining": rt.draining},
                                503)
        else:
            self._send_json({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802
        if urlparse(self.path).path != "/v1/predict":
            self._send_json({"error": "not found"}, 404)
            return
        rt = self.router
        if not rt.enter_request():
            self._send_json({"error": "draining: router is shutting down"},
                            503)
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            code, body = rt.route_predict(raw)
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        finally:
            rt.exit_request()

    def log_message(self, *args):  # quiet
        pass


class Router:
    """HTTP front end routing `/v1/predict` across replica URLs.

    replicas:          backend base URLs (e.g. from `ReplicaProcess.url`);
                       the set is mutable afterwards via
                       `add_replica`/`remove_replica`.
    poll_interval_s:   /readyz + /v1/stats refresh cadence.
    request_timeout_s: per-proxy-attempt timeout toward a replica.
    hedge:             enable hedged requests (default off: bitwise the
                       pre-hedging behavior apart from budget-gated
                       retries).
    hedge_floor_ms /   clamp on the quantile-tracked hedge delay: never
    hedge_ceil_ms:     hedge sooner than the floor (a healthy fast fleet
                       would duplicate half its traffic), never wait
                       longer than the ceiling (the delay is the whole
                       point); with no latency history yet the ceiling
                       is used.
    retry_budget_ratio / retry_budget_min: the `RetryBudget` envelope
                       shared by fail-over retries AND hedges.
    stats_staleness_s: a replica whose last successful poll is older
                       than this is excluded from fleet aggregates and
                       the /metrics re-export (its cached stats are
                       history, not state).
    """

    def __init__(self, replicas: List[str], host: str = "127.0.0.1",
                 port: int = 0, poll_interval_s: float = 0.5,
                 request_timeout_s: float = 35.0,
                 hedge: bool = False,
                 hedge_floor_ms: float = 10.0,
                 hedge_ceil_ms: float = 2000.0,
                 retry_budget_ratio: float = 0.1,
                 retry_budget_min: int = 3,
                 stats_staleness_s: float = 10.0):
        if not replicas:
            raise ValueError("Router needs at least one replica URL")
        self.poll_interval_s = float(poll_interval_s)
        self.request_timeout_s = float(request_timeout_s)
        self.hedge = bool(hedge)
        self.hedge_floor_s = float(hedge_floor_ms) / 1000.0
        self.hedge_ceil_s = float(hedge_ceil_ms) / 1000.0
        self.stats_staleness_s = float(stats_staleness_s)
        self.budget = RetryBudget(ratio=retry_budget_ratio,
                                  min_tokens=retry_budget_min)
        handler = type("Handler", (_RouterHandler,), {"router": self})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        self._poll_stop = threading.Event()
        self._state_lock = threading.Lock()
        # copy-on-write: mutations swap the list under _state_lock,
        # readers grab one immutable snapshot — rotation-safe while the
        # supervisor/autoscaler add and remove replicas mid-flight
        self.replicas: List[Replica] = [Replica(i, u)
                                        for i, u in enumerate(replicas)]
        self._next_index = len(self.replicas)
        self._ready = False
        self._draining = False
        self._drained = False
        self._inflight = 0
        self._rr = 0  # round-robin cursor
        self._stop_requested = threading.Event()
        # fleet control plane (FleetSupervisor / Autoscaler), attached
        # by the CLI so one /v1/stats + /metrics scrape covers it
        self._fleet = None
        self._autoscaler = None
        # -- stats (guarded by _state_lock) --------------------------------
        self._retries = 0
        self._unroutable = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._ok_latencies = deque(maxlen=512)  # hedge-delay quantile feed
        self._reqs_by: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._lat_hist = {p: {"counts": [0] * len(LATENCY_BUCKETS_S),
                              "inf": 0, "sum": 0.0, "count": 0}
                          for p in PRIORITIES}

    # -- fleet mutation ------------------------------------------------------
    def add_replica(self, url: str, host: Optional[str] = None) -> Replica:
        """Register a replica URL (a fresh spawn or a respawn on a new
        ephemeral port) and put it in rotation once it polls ready.
        `host` is the failure-domain label (the agent serving it)."""
        with self._state_lock:
            rep = Replica(self._next_index, url, host=host)
            self._next_index += 1
            self.replicas = self.replicas + [rep]
        rep.poll()  # outside the lock: readiness known before first route
        return rep

    def remove_replica(self, url: str) -> Optional[Replica]:
        """Drop a replica from rotation by URL (or `Replica` instance).
        In-flight proxies holding the old snapshot finish against it —
        callers SIGTERM the process only after this returns, so its own
        graceful drain still answers them."""
        target = url.url if isinstance(url, Replica) else url.rstrip("/")
        with self._state_lock:
            for rep in self.replicas:
                if rep.url == target:
                    self.replicas = [r for r in self.replicas if r is not rep]
                    return rep
        return None

    def find_replica(self, url: str) -> Optional[Replica]:
        target = url.rstrip("/")
        for rep in self.replicas:
            if rep.url == target:
                return rep
        return None

    def attach_fleet(self, supervisor=None, autoscaler=None) -> None:
        """Attach the fleet control plane so `stats()` (and therefore
        /metrics) carries its `fleet` / `autoscaler` blocks."""
        with self._state_lock:
            self._fleet = supervisor
            self._autoscaler = autoscaler

    # -- admission ----------------------------------------------------------
    @property
    def draining(self) -> bool:
        with self._state_lock:
            return self._draining

    def is_ready(self) -> bool:
        with self._state_lock:
            if not self._ready or self._draining:
                return False
        return self.healthy_count() > 0

    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas if r.ready)

    def enter_request(self) -> bool:
        with self._state_lock:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def exit_request(self) -> None:
        with self._state_lock:
            self._inflight -= 1

    # -- routing ------------------------------------------------------------
    def _rotation(self) -> List[Replica]:
        """Routable replicas starting at the round-robin cursor; when
        none pass `routable()` fall back to every ready replica (a
        breaker-open replica beats answering 503 outright)."""
        with self._state_lock:
            reps = self.replicas  # immutable snapshot
            start = self._rr
            self._rr += 1
        if not reps:
            return []
        order = [reps[(start + i) % len(reps)] for i in range(len(reps))]
        routable = [r for r in order if r.routable()]
        return self._prefer_other_hosts(
            routable or [r for r in order if r.ready])

    @staticmethod
    def _prefer_other_hosts(rotation: List[Replica]) -> List[Replica]:
        """Failure-domain ordering: keep the round-robin primary, but
        sort the tail so hedges and retries land on a DIFFERENT host
        than the primary first — a host-level failure (dead agent,
        partition) then cannot eat both the attempt and its backup.
        Single-host fleets are untouched (the tail is homogeneous)."""
        if len(rotation) < 3:
            return rotation
        primary = rotation[0]
        tail = rotation[1:]
        other = [r for r in tail if r.host != primary.host]
        if not other or len(other) == len(tail):
            return rotation
        same = [r for r in tail if r.host == primary.host]
        return [primary] + other + same

    @staticmethod
    def _request_priority(raw: bytes) -> str:
        """The request's priority class, for the router's own per-class
        accounting; malformed bodies count as the default class and are
        forwarded untouched — the replica owns rejection."""
        try:
            prio = json.loads(raw.decode() or "{}").get("priority",
                                                        "interactive")
        except (ValueError, UnicodeDecodeError):
            return "interactive"
        return prio if prio in PRIORITIES else "interactive"

    def _observe(self, priority: str, latency_s: float, ok: bool) -> None:
        with self._state_lock:
            self._reqs_by[priority] += 1
            if ok:
                self._ok_latencies.append(latency_s)
                h = self._lat_hist[priority]
                h["sum"] += latency_s
                h["count"] += 1
                for i, bound in enumerate(LATENCY_BUCKETS_S):
                    if latency_s <= bound:
                        h["counts"][i] += 1
                        break
                else:
                    h["inf"] += 1

    def hedge_delay_s(self) -> float:
        """How long the primary attempt may run before a hedge fires:
        the p95 of recent successful route latencies, clamped to
        [floor, ceiling]; the ceiling until there is history."""
        with self._state_lock:
            lats = sorted(self._ok_latencies)
        if not lats:
            return self.hedge_ceil_s
        p95 = lats[min(len(lats) - 1, int(0.95 * (len(lats) - 1)))]
        return min(max(p95, self.hedge_floor_s), self.hedge_ceil_s)

    def _attempt(self, rep: Replica, raw: bytes) -> Tuple[str, int, bytes]:
        """One proxy attempt; never raises.  Returns ("ok"|"retryable",
        code, body): "ok" is the replica's verdict on the REQUEST
        (pass through — 200, 400, 504...), "retryable" means THIS
        replica can't serve anyone (connection failure, 502/503) and a
        sibling may."""
        try:
            faults.fire("router.proxy", replica=rep.index)
        except Exception as e:  # noqa: BLE001 — an armed fault = failure
            rep.breaker.record_failure()
            return ("retryable", 502, json.dumps(
                {"error": f"replica {rep.index} proxy fault: {e}"}).encode())
        req = Request(rep.url + "/v1/predict", data=raw,
                      headers={"Content-Type": "application/json"},
                      method="POST")
        try:
            with urlopen(req, timeout=self.request_timeout_s) as r:
                code, body = r.status, r.read()
        except HTTPError as e:
            code, body = e.code, e.read()
        except (URLError, OSError) as e:
            rep.breaker.record_failure()
            return ("retryable", 502, json.dumps(
                {"error": f"replica {rep.index} unreachable: {e}"}).encode())
        if code in _RETRYABLE_CODES:
            rep.breaker.record_failure()
            return ("retryable", code, body)
        rep.breaker.record_success()
        return ("ok", code, body)

    def route_predict(self, raw: bytes):
        """Proxy one predict body; returns (status code, response bytes).

        Fail-over policy: connection-level failures and 502/503 from a
        replica trip its breaker and move on to the next; any other
        answer (200, 400, 504...) is the replica's verdict on the
        REQUEST and passes through with a breaker success.  Every extra
        attempt — the hedge fired when the primary outlives
        `hedge_delay_s()`, and each sequential fail-over retry — draws
        from the shared `RetryBudget`; when the budget is exhausted the
        request degrades to single-attempt (no storm), returning
        whatever its one attempt produced."""
        priority = self._request_priority(raw)
        t0 = time.monotonic()
        self.budget.note_request()
        rotation = self._rotation()
        if not rotation:
            self._observe(priority, time.monotonic() - t0, False)
            with self._state_lock:
                self._unroutable += 1
            return 503, json.dumps({"error": "no healthy replica"}).encode()

        results: _queue.Queue = _queue.Queue()
        inflight = [0]

        def launch(rep: Replica, tag: str) -> None:
            inflight[0] += 1

            def _run():
                results.put((tag, self._attempt(rep, raw)))

            threading.Thread(target=_run, daemon=True,
                             name=f"dl4j-router-{tag}").start()

        deadline = t0 + self.request_timeout_s + 1.0
        launch(rotation[0], "primary")
        next_idx = 1        # next rotation slot for a hedge or retry
        hedge_armed = (self.hedge and len(rotation) > 1)
        last: Optional[Tuple[int, bytes]] = None
        while True:
            now = time.monotonic()
            if hedge_armed:
                wait_s = min(self.hedge_delay_s(), deadline - now)
            else:
                wait_s = deadline - now
            if wait_s <= 0:
                break  # request_timeout exhausted with attempts in flight
            try:
                tag, (kind, code, body) = results.get(timeout=wait_s)
            except _queue.Empty:
                if hedge_armed:
                    # primary is slow: fire the hedge (budget allowing)
                    hedge_armed = False
                    if self.budget.try_spend():
                        with self._state_lock:
                            self._hedges += 1
                        launch(rotation[next_idx], "hedge")
                        next_idx += 1
                    continue
                break
            inflight[0] -= 1
            hedge_armed = False  # an outcome landed; hedging moment over
            if kind == "ok":
                if tag == "hedge":
                    with self._state_lock:
                        self._hedge_wins += 1
                self._observe(priority, time.monotonic() - t0, code == 200)
                return code, body
            last = (code, body)
            if inflight[0] > 0:
                continue  # a sibling attempt is still in flight: wait it out
            if next_idx >= len(rotation):
                break  # rotation exhausted
            if not self.budget.try_spend():
                break  # budget exhausted: degrade to what we already have
            with self._state_lock:
                self._retries += 1
            launch(rotation[next_idx], "retry")
            next_idx += 1
        self._observe(priority, time.monotonic() - t0, False)
        with self._state_lock:
            self._unroutable += 1
        if last is not None:
            return last
        return 503, json.dumps(
            {"error": "no attempt completed in time"}).encode()

    # -- health polling ------------------------------------------------------
    def _poll_all(self, timeout_s: float = 2.0) -> None:
        """Poll every replica CONCURRENTLY (one short-lived thread per
        replica) and wait at most ~timeout_s: one wedged replica's poll
        can no longer delay failure detection of its siblings by
        2 s x fleet size — the straggler thread is abandoned (daemon)
        and its late answer still lands under the replica's own lock."""
        reps = self.replicas
        threads = []
        for rep in reps:
            t = threading.Thread(target=rep.poll, args=(timeout_s,),
                                 daemon=True,
                                 name=f"dl4j-poll-{rep.index}")
            t.start()
            threads.append(t)
        deadline = time.monotonic() + timeout_s + 0.5
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.01))

    def _poll_loop(self) -> None:
        # wait first: start() already polled synchronously, and polling
        # again right away would race a caller who changes the fleet
        # between start() and the first interval
        while not self._poll_stop.wait(self.poll_interval_s):
            self._poll_all()

    def poll_once(self, timeout_s: float = 2.0) -> int:
        """Synchronous concurrent health refresh of every replica
        (startup, tests); returns how many are ready."""
        self._poll_all(timeout_s)
        return self.healthy_count()

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._state_lock:
            priorities = {
                p: {"requests": self._reqs_by[p],
                    "latency_hist_s": {
                        "bounds": list(LATENCY_BUCKETS_S),
                        "counts": list(self._lat_hist[p]["counts"]),
                        "inf": self._lat_hist[p]["inf"],
                        "sum": self._lat_hist[p]["sum"],
                        "count": self._lat_hist[p]["count"]}}
                for p in PRIORITIES}
            out = {
                "ready": self._ready and not self._draining,
                "draining": self._draining,
                "inflight": self._inflight,
                "retries": self._retries,
                "unroutable": self._unroutable,
                "hedges": self._hedges,
                "hedge_wins": self._hedge_wins,
                "hedge_enabled": self.hedge,
                "priorities": priorities,
            }
        out["hedge_delay_s"] = round(self.hedge_delay_s(), 4)
        out["retry_budget"] = self.budget.stats()
        out["replicas"] = [r.describe(self.stats_staleness_s)
                           for r in self.replicas]
        out["healthy_replicas"] = self.healthy_count()
        # per-host (failure-domain) rollup: breaker trips aggregated by
        # the host label, so a dying HOST reads as one signal even when
        # its replicas trip breakers one by one
        hosts: dict = {}
        for rep in out["replicas"]:
            h = hosts.setdefault(rep.get("host") or "local",
                                 {"replicas": 0, "healthy": 0,
                                  "breaker_opens": 0, "breakers_open": 0})
            h["replicas"] += 1
            if rep.get("healthy"):
                h["healthy"] += 1
            brk = rep.get("breaker") or {}
            h["breaker_opens"] += int(brk.get("opens", 0))
            if brk.get("state") == "open":
                h["breakers_open"] += 1
        out["hosts"] = hosts
        # fleet-wide per-precision-policy rows, aggregated from each
        # replica's last-polled /v1/stats precision block (the
        # policy-labeled Prometheus re-export keeps the per-replica
        # split; this is the one-number fleet view).  Stale replicas —
        # dead ones whose cached stats outlived stats_staleness_s — are
        # history, not state, and stay out of the aggregate.
        rows_by_policy: dict = {}
        for rep in out["replicas"]:
            if rep.get("stale"):
                continue
            prec = (rep.get("stats") or {}).get("precision") or {}
            for pol, rows in prec.get("rows_by_policy", {}).items():
                rows_by_policy[pol] = rows_by_policy.get(pol, 0) + int(rows)
        out["rows_by_policy"] = rows_by_policy
        # fleet control plane, when attached (no locks held here:
        # supervisor/autoscaler stats take their own locks)
        if self._fleet is not None:
            out["fleet"] = self._fleet.stats()
        if self._autoscaler is not None:
            out["autoscaler"] = self._autoscaler.stats()
        return out

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "Router":
        self.poll_once()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="dl4j-router-health", daemon=True)
        self._poll_thread.start()
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        with self._state_lock:
            self._ready = True
        return self

    def request_stop(self) -> None:
        """Signal-handler-safe: set the event; the thread parked in
        `wait_for_stop()` performs the drain."""
        self._stop_requested.set()

    def wait_for_stop(self, timeout: Optional[float] = None) -> bool:
        return self._stop_requested.wait(timeout)

    def drain(self, timeout_s: float = 10.0) -> None:
        """Stop admitting (predicts/readyz → 503), wait out in-flight
        proxies, close.  Replica processes outlive this call — the
        caller SIGTERMs them afterwards so every accepted request still
        finds its replica; idempotent."""
        with self._state_lock:
            if self._drained:
                return
            self._drained = True
            self._draining = True
        self._stop_requested.set()
        self._poll_stop.set()
        deadline = time.monotonic() + float(timeout_s)
        if self._thread is not None:
            self.server.shutdown()
        while time.monotonic() < deadline:
            with self._state_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.005)
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=max(deadline - time.monotonic(),
                                               0.1))
        self.server.server_close()

    def stop(self) -> None:
        self.drain()

    @property
    def url(self) -> str:
        return f"http://{self.server.server_address[0]}:{self.port}"

"""Per-host replica agent: the control plane's remote hands.

A multi-host fleet needs the supervisor to drive
replicas on machines it cannot `fork` on.  The TensorFlow control-
plane/data-plane split (PAPERS.md) is the blueprint: one thin, model-
free agent per host owns the local replica processes, and the central
`FleetSupervisor` talks to it over the same poll/terminate surface it
uses for local handles.  Like `router.py`, this module NEVER imports
jax — an agent stays a few MB of stdlib while its children own the
device runtime.

Server half — `ReplicaAgent`, one per host (`cli agent`):

  POST /a/spawn     {"argv": ["serve", ...]} → spawn one replica child
                    and block until its startup JSON arrives; answers
                    {"id", "url", "pid", "summary"}.  Only `serve` argv
                    is accepted (the agent is a replica nursery, not a
                    remote shell), capacity is bounded by
                    `max_replicas`, and when the agent owns a compile-
                    cache directory it pins the child's --compile-cache
                    to it (the host's disk is the host's cache).
  POST /a/stop      {"id", "kill"?, "wait"?} → SIGTERM (or SIGKILL) the
                    child; with "wait" the answer carries its exit code.
  GET  /a/health    liveness + counters (the supervisor's lease
                    heartbeat target).
  GET  /a/replicas  every child ever spawned: id, url, pid, alive,
                    exit_code, startup summary — the reconcile source
                    of truth after a partition heals.
  GET  /a/cache/{k} one compile-cache entry's raw bytes (serving half
                    of serving/cachesync.py) — a cold peer warms by
                    fetching instead of compiling.

Client half — used by the supervisor:

  `AgentClient`         typed HTTP client; EVERY call carries an
                        explicit timeout (linted: unbounded-network-
                        call) and fires the ``agent.spawn`` /
                        ``agent.poll`` fault points.
  `RemoteReplicaHandle` one remote replica with the exact
                        `ReplicaProcess` surface (`wait_ready`, `url`,
                        `poll`, `terminate`, `wait`, `kill`,
                        `summary`), so `FleetSupervisor` slots hold
                        local and remote processes interchangeably.
                        `poll()` is NON-BLOCKING by design — it reads
                        the client's last `/a/replicas` snapshot
                        (refreshed once per supervisor tick), because
                        the supervisor calls it under its own lock and
                        a network read there would stall the fleet on
                        one slow agent.

The port's own copy of `deeplearning4j_tpu/serving/agent.py`.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.error import HTTPError, URLError
from urllib.parse import urlparse
from urllib.request import Request, urlopen

from deeplearning4j_tpu_torch.reliability import faults
from deeplearning4j_tpu_torch.serving import cachesync

#: exit code reported for a replica the agent had to SIGKILL and for a
#: replica whose agent vanished before its real code could be read
UNKNOWN_EXIT = -9


class _Child:
    """One replica child as the agent tracks it."""

    def __init__(self, child_id: int, handle, summary: Optional[dict]):
        self.id = child_id
        self.handle = handle
        self.summary = summary
        self.exit_code: Optional[int] = None

    def refresh(self) -> Optional[int]:
        """Latest exit code (None while alive); sticky once seen."""
        if self.exit_code is None and self.handle is not None:
            self.exit_code = self.handle.poll()
        return self.exit_code

    def describe(self) -> dict:
        rc = self.refresh()
        return {
            "id": self.id,
            "url": getattr(self.handle, "url", None),
            "pid": getattr(self.handle, "pid", None),
            "alive": rc is None,
            "exit_code": rc,
            "summary": self.summary,
        }


class _AgentHandler(BaseHTTPRequestHandler):
    agent: "ReplicaAgent" = None

    def _send_json(self, body, code: int = 200) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        path = urlparse(self.path).path
        ag = self.agent
        cached = cachesync.handle_cache_get(ag.cache_dir, path)
        if cached is not None:
            ag.note_cache_request(cached[0] == 200)
            code, ctype, body = cached
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path == "/a/health":
            self._send_json(ag.health())
        elif path == "/a/replicas":
            self._send_json({"ok": True, "replicas": ag.describe_children()})
        else:
            self._send_json({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802
        path = urlparse(self.path).path
        ag = self.agent
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n).decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            self._send_json({"error": "bad JSON body"}, 400)
            return
        if path == "/a/spawn":
            code, out = ag.spawn(body.get("argv") or [])
            self._send_json(out, code)
        elif path == "/a/stop":
            code, out = ag.stop_child(body.get("id"),
                                      kill=bool(body.get("kill")),
                                      wait=bool(body.get("wait")),
                                      timeout_s=body.get("timeout_s"))
            self._send_json(out, code)
        else:
            self._send_json({"error": "not found"}, 404)

    def log_message(self, *args):  # quiet
        pass


class ReplicaAgent:
    """The per-host control plane endpoint (see the module docstring).

    spawn_fn:     (argv: List[str]) -> handle with the `ReplicaProcess`
                  surface; the CLI passes a subprocess factory, tests
                  pass in-process fakes.  The agent calls the handle's
                  `wait_ready()` itself — a spawn answer means the
                  replica is listening and warmed.
    cache_dir:    compile-cache directory this agent pins onto every
                  child AND serves under /a/cache/ (None: children keep
                  the caller's argv, nothing is served).
    max_replicas: live-children bound; spawns beyond it answer 409.
    clock:        injectable monotonic clock (uptime reporting only).
    """

    def __init__(self, spawn_fn: Callable[[List[str]], object],
                 host: str = "127.0.0.1", port: int = 0,
                 cache_dir: Optional[str] = None, max_replicas: int = 4,
                 clock=time.monotonic):
        self.spawn_fn = spawn_fn
        self.cache_dir = cache_dir
        self.max_replicas = int(max_replicas)
        self._clock = clock
        self._started_at = clock()
        self._lock = threading.Lock()
        self._children: Dict[int, _Child] = {}
        self._next_id = 0
        self._pending = 0          # spawns in flight (capacity-reserved)
        self._spawns_total = 0
        self._spawn_failures_total = 0
        self._stops_total = 0
        self._cache_requests_total = 0
        self._cache_hits_total = 0
        handler = type("Handler", (_AgentHandler,), {"agent": self})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- children ------------------------------------------------------------
    @staticmethod
    def _pin_cache(argv: List[str], cache_dir: str) -> List[str]:
        """Child argv with --compile-cache pinned to this host's dir
        (strip any caller-supplied pair first: the host owns its disk)."""
        out: List[str] = []
        skip = False
        for a in argv:
            if skip:
                skip = False
                continue
            if a == "--compile-cache":
                skip = True
                continue
            out.append(a)
        return out + ["--compile-cache", cache_dir]

    def spawn(self, argv: List[str]):
        """Spawn one replica child from `argv` (must be a `serve`
        command line) and block until it reports ready.  Returns
        (http status, body dict); every failure is a clean JSON error."""
        if not argv or argv[0] != "serve":
            return 400, {"error": "argv must be a 'serve' command line"}
        with self._lock:
            live = sum(1 for c in self._children.values()
                       if c.refresh() is None)
            if live + self._pending >= self.max_replicas:
                return 409, {"error": f"at max_replicas "
                                      f"({self.max_replicas})"}
            self._pending += 1
            child_id = self._next_id
            self._next_id += 1
        if self.cache_dir:
            argv = self._pin_cache(list(argv), self.cache_dir)
        try:
            handle = self.spawn_fn(list(argv))
            summary = handle.wait_ready()
        except BaseException as e:  # noqa: BLE001 — incl. SystemExit
            # from wait_ready on a child dead at startup: a clean 500,
            # never an agent crash
            with self._lock:
                self._pending -= 1
                self._spawn_failures_total += 1
            return 500, {"error": f"spawn failed: {e}"}
        child = _Child(child_id, handle, summary)
        with self._lock:
            self._pending -= 1
            self._spawns_total += 1
            self._children[child_id] = child
        return 200, {"id": child.id, "url": getattr(handle, "url", None),
                     "pid": getattr(handle, "pid", None),
                     "summary": summary}

    def stop_child(self, child_id, kill: bool = False, wait: bool = False,
                   timeout_s: Optional[float] = None):
        with self._lock:
            child = self._children.get(child_id) \
                if isinstance(child_id, int) else None
            if child is None:
                return 404, {"error": f"no replica {child_id!r}"}
            self._stops_total += 1
        if kill:
            child.handle.kill()
        else:
            child.handle.terminate()
        rc = None
        if wait:
            try:
                rc = child.handle.wait(timeout=(30.0 if timeout_s is None
                                                else float(timeout_s)))
            except Exception:  # noqa: BLE001 — wedged child: escalate
                child.handle.kill()
                try:
                    rc = child.handle.wait(timeout=5.0)
                except Exception:  # noqa: BLE001 — truly stuck
                    rc = UNKNOWN_EXIT
            child.exit_code = rc
        return 200, {"id": child.id, "exit_code": rc}

    def describe_children(self) -> List[dict]:
        with self._lock:
            children = list(self._children.values())
        return [c.describe() for c in children]

    def note_cache_request(self, hit: bool) -> None:
        with self._lock:
            self._cache_requests_total += 1
            if hit:
                self._cache_hits_total += 1

    # -- observability -------------------------------------------------------
    def health(self) -> dict:
        live = sum(1 for c in self.describe_children() if c["alive"])
        with self._lock:
            return {
                "ok": True,
                "replicas": live,
                "max_replicas": self.max_replicas,
                "uptime_s": round(self._clock() - self._started_at, 3),
                "spawns_total": self._spawns_total,
                "spawn_failures_total": self._spawn_failures_total,
                "stops_total": self._stops_total,
                "cache_requests_total": self._cache_requests_total,
                "cache_hits_total": self._cache_hits_total,
                "cache_dir": self.cache_dir,
            }

    # -- lifecycle -----------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.server.server_address[0]}:{self.port}"

    def start(self) -> "ReplicaAgent":
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="dl4j-agent")
        self._thread.start()
        return self

    def stop(self, terminate_children: bool = False,
             drain_timeout_s: float = 30.0) -> List[Optional[int]]:
        """Stop serving; with `terminate_children` also SIGTERM every
        live child and collect exit codes (the `cli agent` SIGTERM
        path)."""
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        rcs: List[Optional[int]] = []
        if terminate_children:
            with self._lock:
                children = list(self._children.values())
            for c in children:
                if c.refresh() is None:
                    c.handle.terminate()
            for c in children:
                if c.exit_code is not None:
                    rcs.append(c.exit_code)
                    continue
                try:
                    c.exit_code = c.handle.wait(timeout=drain_timeout_s)
                except Exception:  # noqa: BLE001 — wedged: escalate
                    c.handle.kill()
                    try:
                        c.exit_code = c.handle.wait(timeout=5.0)
                    except Exception:  # noqa: BLE001
                        c.exit_code = UNKNOWN_EXIT
                rcs.append(c.exit_code)
        return rcs


# -- client side (the supervisor's view) -------------------------------------

class AgentClient:
    """HTTP client for one `ReplicaAgent`; every request carries an
    explicit timeout and the lease-relevant calls traverse fault
    points (``agent.spawn``, ``agent.poll``).

    The client also caches the last successful `/a/replicas` snapshot:
    `RemoteReplicaHandle.poll()` reads it without touching the network,
    and the supervisor refreshes it once per tick via `refresh()` —
    one roundtrip per agent per tick, however many replicas it hosts.
    """

    def __init__(self, url: str, timeout_s: float = 10.0,
                 spawn_timeout_s: float = 600.0):
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        # the host LABEL for failure-domain routing: one label per
        # agent endpoint, shared by every replica it hosts
        self.host = urlparse(self.url).netloc or self.url
        self._lock = threading.Lock()
        # rid -> exit code (None while alive); replaced wholesale by
        # refresh(), primed by spawn() so a brand-new replica polls as
        # alive before the first snapshot
        self._snapshot: Dict[int, Optional[int]] = {}
        self._snapshot_fresh = False

    # -- raw HTTP ------------------------------------------------------------
    def _get(self, path: str, timeout_s: Optional[float] = None) -> dict:
        with urlopen(self.url + path,
                     timeout=self.timeout_s if timeout_s is None
                     else timeout_s) as r:
            return json.loads(r.read().decode())

    def _post(self, path: str, body: dict,
              timeout_s: Optional[float] = None) -> dict:
        req = Request(self.url + path, data=json.dumps(body).encode(),
                      headers={"Content-Type": "application/json"},
                      method="POST")
        try:
            with urlopen(req, timeout=self.timeout_s if timeout_s is None
                         else timeout_s) as r:
                return json.loads(r.read().decode())
        except HTTPError as e:
            # agent-level verdicts (409 at capacity, 404 unknown id,
            # 500 spawn failed) arrive as clean JSON errors
            try:
                detail = json.loads(e.read().decode()).get("error", "")
            except Exception:  # noqa: BLE001 — undecodable error body
                detail = ""
            raise RuntimeError(
                f"agent {self.url}{path} -> {e.code}: {detail}") from e

    # -- control-plane verbs -------------------------------------------------
    def health(self) -> dict:
        return self._get("/a/health")

    def spawn(self, argv: List[str]) -> "RemoteReplicaHandle":
        """Ask the agent for one replica; blocks until the child is
        warmed and listening (the agent answers only then)."""
        faults.fire("agent.spawn", agent=self.url)
        info = self._post("/a/spawn", {"argv": list(argv)},
                          timeout_s=self.spawn_timeout_s)
        with self._lock:
            self._snapshot[info["id"]] = None
        return RemoteReplicaHandle(self, info)

    def stop(self, rid: int, kill: bool = False, wait: bool = False,
             timeout_s: Optional[float] = None) -> dict:
        body = {"id": rid, "kill": kill, "wait": wait}
        if timeout_s is not None:
            body["timeout_s"] = timeout_s
        http_timeout = self.timeout_s if not wait \
            else (30.0 if timeout_s is None else timeout_s) + self.timeout_s
        out = self._post("/a/stop", body, timeout_s=http_timeout)
        if out.get("exit_code") is not None:
            with self._lock:
                self._snapshot[rid] = out["exit_code"]
        return out

    def replicas(self) -> List[dict]:
        return self._get("/a/replicas").get("replicas", [])

    def refresh(self) -> List[dict]:
        """One `/a/replicas` poll: replaces the cached exit-code
        snapshot and returns the raw records.  Raises on an unreachable
        agent — the supervisor's lease machinery counts that as a
        missed heartbeat.  Traverses ``agent.poll``."""
        faults.fire("agent.poll", agent=self.url)
        records = self.replicas()
        with self._lock:
            self._snapshot = {r["id"]: r.get("exit_code")
                              for r in records}
            self._snapshot_fresh = True
        return records

    def cached_exit(self, rid: int) -> Optional[int]:
        """Last known exit code for `rid` from the snapshot (None =
        alive as far as the last successful poll knew).  A replica
        MISSING from a fresh snapshot is gone — its agent restarted
        and lost it — which reads as `UNKNOWN_EXIT`, so the supervisor
        reaps and respawns it."""
        with self._lock:
            if rid in self._snapshot:
                return self._snapshot[rid]
            return UNKNOWN_EXIT if self._snapshot_fresh else None

    def describe(self) -> dict:
        with self._lock:
            return {"url": self.url, "host": self.host,
                    "known_replicas": len(self._snapshot)}


class RemoteReplicaHandle:
    """A replica on another host, with the `ReplicaProcess` surface the
    supervisor and the CLI shutdown sweep already speak.

    poll() never touches the network (see `AgentClient`); terminate()/
    kill() are best-effort against a possibly-partitioned agent (the
    lease machinery, not the signal path, owns that failure mode)."""

    def __init__(self, client: AgentClient, info: dict):
        self.client = client
        self.rid = int(info["id"])
        self.summary: Optional[dict] = info.get("summary")
        self._url = info.get("url")
        self._pid = info.get("pid")
        self._killed = False

    def wait_ready(self) -> dict:
        # the agent's spawn answer already waited for the child's
        # startup JSON; there is nothing left to block on
        return self.summary or {}

    @property
    def url(self) -> Optional[str]:
        return self._url

    @property
    def pid(self) -> Optional[int]:
        return self._pid

    @property
    def host(self) -> str:
        return self.client.host

    def poll(self) -> Optional[int]:
        return self.client.cached_exit(self.rid)

    def terminate(self) -> None:
        try:
            self.client.stop(self.rid, wait=False)
        except Exception:  # noqa: BLE001 — unreachable agent: the child
            pass           # either drains on its own or the host is gone

    def kill(self) -> None:
        self._killed = True
        try:
            self.client.stop(self.rid, kill=True, wait=False)
        except Exception:  # noqa: BLE001 — same as terminate
            pass

    def wait(self, timeout: Optional[float] = None) -> int:
        """Exit code via the agent's waiting /a/stop-less poll; bounded
        by `timeout`.  On an unreachable agent after `kill()` the code
        is unknowable — report `UNKNOWN_EXIT` instead of wedging the
        CLI's shutdown sweep."""
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        while True:
            try:
                for rec in self.client.replicas():
                    if rec.get("id") == self.rid and \
                            rec.get("exit_code") is not None:
                        return rec["exit_code"]
            except Exception:  # noqa: BLE001 — agent unreachable
                if self._killed:
                    return UNKNOWN_EXIT
            if deadline is not None and time.monotonic() >= deadline:
                if self._killed:
                    return UNKNOWN_EXIT
                raise TimeoutError(
                    f"replica {self.rid} on {self.client.url} still "
                    f"alive after {timeout}s")
            time.sleep(0.05)


__all__ = ["AgentClient", "RemoteReplicaHandle", "ReplicaAgent",
           "UNKNOWN_EXIT"]

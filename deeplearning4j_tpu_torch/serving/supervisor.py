"""Fleet supervision: replicas that die come back, ones that crash-loop
don't get to take the fleet with them.

The router (serving/router.py) routes AROUND a dead replica; this module
is the control-plane half the datacenter shape requires: someone has to
notice the corpse, reap it, and put a fresh replica in rotation —
without an operator, and without a hot respawn loop when the crash is
deterministic.  `FleetSupervisor` owns the replica process set behind
`serve --replicas N`:

  reap      a watcher thread polls every handle's `poll()` (the
            `Popen.returncode` probe); a death is logged with its exit
            code and the replica's URL leaves the router rotation
            immediately, so the fleet stops burning fail-over retries
            on a corpse.
  respawn   each death schedules a respawn after full-jitter exponential
            backoff — the same `backoff_seconds` shape the dataset
            fetcher uses (attempt k waits U(0,1) * min(8s, 0.5 * 2^k)).
            A respawned replica warms from the SHARED disk compile
            cache, so coming back is seconds of process startup, not
            minutes of XLA compiles (`fresh_compiles == 0` is asserted
            in the chaos tests).  The new process lands on a new
            ephemeral port; its URL is re-registered with the router's
            mutable replica set.
  quarantine a replica that dies `max_restarts` times inside
            `restart_window_s` is CRASH-LOOPING — respawning it faster
            only turns a deterministic bug into a fork bomb.  The slot
            is quarantined for `quarantine_s`, after which ONE probe
            respawn is allowed (the window has drained, so a further
            death re-quarantines after the remaining budget).
  scale     `scale_up()` / `scale_down()` are the autoscaler's verbs.
            Up spawns into the first free slot (bounded by
            `max_replicas`).  Down picks the EMPTIEST running replica
            (lowest last-polled queue depth), pulls it from rotation
            FIRST, then SIGTERMs it — the replica's own graceful drain
            answers everything it had accepted, so scale-down provably
            drops zero requests.

Multi-host: with `agents=[...]` the same slots are
backed by `RemoteReplicaHandle`s driven through per-host `ReplicaAgent`
control planes (serving/agent.py) instead of local forks.  Remote
supervision is LEASE-BASED, because a network edge fails in a way a
local `poll()` cannot — the agent may be fine while the path to it is
not:

  lease     every tick heartbeats each agent once (`/a/replicas`,
            explicit timeout); a success refreshes the exit-code
            snapshot every remote handle's non-blocking `poll()` reads.
  partition `lease_misses` consecutive failed heartbeats mark the agent
            PARTITIONED: its running slots move to the "partitioned"
            state and leave the router rotation — unreachable is not
            dead, so nothing is respawned yet (respawning a replica
            that is still serving on the far side would double-spawn).
  failover  a partition older than `agent_failover_s` is treated as a
            lost host: its slots book a death and respawn onto the
            surviving leased agents (round-robin), warming over the
            cachesync wire instead of compiling.
  reconcile when a partitioned agent's lease is re-acquired, actual
            agent state is reconciled against intent: still-live
            replicas are ADOPTED back into rotation (never respawned),
            dead ones book a normal death, and live agent children the
            supervisor no longer intends (a slot failed over meanwhile)
            are stopped — zero double-spawns either way.

Lock ordering: the supervisor calls `router.add_replica`/
`remove_replica` (which take the router's `_state_lock`) only OUTSIDE
its own `_lock`, and the router calls `supervisor.stats()` without
holding its state lock — no lock cycle exists.  Agent heartbeats are
network calls and also happen outside `_lock`.

Fault-injection: every (re)spawn traverses the ``supervisor.spawn``
point (reliability/faults.py); arming it is how the quarantine tests
make respawns fail deterministically.  Every agent heartbeat traverses
``agent.partition`` — arming `raise` there simulates a network
partition between the supervisor and a perfectly healthy agent.

`spawn_fn` is any zero-arg callable returning a process handle with the
`ReplicaProcess` surface (`wait_ready()`, `url`, `poll()`,
`terminate()`, `wait()`, `kill()`); tests substitute in-process fakes
wrapping real `ModelServer`s.

The port's own copy of `deeplearning4j_tpu/serving/supervisor.py`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.datasets.fetch import backoff_seconds
from deeplearning4j_tpu_torch.reliability import faults

#: slot lifecycle states (exported as dl4j_fleet_replicas{state=...};
#: every state is always exported, zeros included, so dashboards see a
#: stable label set).  "partitioned" is remote-only: the replica is
#: unreachable but not known dead, so it is out of rotation yet NOT
#: respawned until the lease failover deadline passes.
STATES = ("running", "backoff", "quarantined", "stopped", "partitioned")


class _AgentState:
    """One remote agent as the supervisor leases it."""

    def __init__(self, client):
        if isinstance(client, str):
            from deeplearning4j_tpu_torch.serving.agent import AgentClient

            client = AgentClient(client)
        self.client = client
        self.url = client.url
        #: failure-domain label shared by every replica this agent hosts
        self.host = getattr(client, "host", client.url)
        self.state = "leased"            # or "partitioned"
        self.missed = 0                  # consecutive failed heartbeats
        self.last_ok: Optional[float] = None
        self.partitioned_at: Optional[float] = None
        self.replicas_live = 0           # from the last good snapshot
        self.partitions_total = 0
        self.reconciles_total = 0
        self.adopted_total = 0
        self.orphans_stopped_total = 0
        self.failovers_total = 0

    def describe(self) -> dict:
        return {
            "url": self.url, "host": self.host, "state": self.state,
            "missed_heartbeats": self.missed,
            "replicas_live": self.replicas_live,
            "partitions_total": self.partitions_total,
            "reconciles_total": self.reconciles_total,
            "adopted_total": self.adopted_total,
            "orphans_stopped_total": self.orphans_stopped_total,
            "failovers_total": self.failovers_total,
        }


class _Slot:
    """One supervised replica position: the process handle currently
    filling it plus the death/backoff/quarantine bookkeeping."""

    def __init__(self, slot_id: int):
        self.id = slot_id
        self.handle = None
        self.url: Optional[str] = None
        self.state = "stopped"
        self.host = "local"              # failure-domain label
        self.agent: Optional[_AgentState] = None
        self.deaths: deque = deque()     # timestamps inside the window
        self.attempt = 0                 # consecutive failed comebacks
        self.restarts = 0
        self.last_exit: Optional[int] = None
        self.next_spawn_at: Optional[float] = None
        self.quarantined_at: Optional[float] = None
        self.summary: Optional[dict] = None

    def describe(self, now: float) -> dict:
        quarantined = (self.state == "quarantined"
                       and self.next_spawn_at is not None)
        return {
            "id": self.id,
            "url": self.url,
            "state": self.state,
            "host": self.host,
            "agent": self.agent.url if self.agent is not None else None,
            "restarts": self.restarts,
            "deaths_in_window": len(self.deaths),
            "last_exit": self.last_exit,
            # the respawn warms from the shared disk cache: this staying
            # 0 across restarts is the "seconds, not compiles" proof
            "fresh_compiles": (self.summary or {}).get("fresh_compiles"),
            # ... and for a REMOTE respawn the warmth arrived over the
            # cachesync wire: fetch hits > 0 with fresh_compiles == 0
            # is the "warmed, never compiled" proof
            "cache_fetch_hits": ((self.summary or {})
                                 .get("disk_cache") or {}).get("fetch_hits"),
            "backoff_remaining_s": (
                None if self.next_spawn_at is None
                else round(max(self.next_spawn_at - now, 0.0), 3)),
            # on the supervisor's own clock (monotonic): when the
            # quarantine probe unlocks, and how far away that is
            "quarantined_until": (self.next_spawn_at if quarantined
                                  else None),
            "quarantine_remaining_s": (
                round(max(self.next_spawn_at - now, 0.0), 3)
                if quarantined else 0.0),
        }


class FleetSupervisor:
    """Owns the replica process set: reap, respawn with backoff,
    quarantine crash-loops, scale between min and max replicas.

    spawn_fn:         () -> handle; must block-start the process (the
                      supervisor calls `wait_ready()` itself).
    router:           the mutable-replica-set `Router` to (de)register
                      URLs with.
    initial:          already-ready handles adopted at construction
                      (the CLI spawns the initial fleet before the
                      router exists, then hands the handles over).
    max_restarts / restart_window_s: the crash-loop breaker — that many
                      deaths inside the window quarantines the slot.
    quarantine_s:     how long a quarantined slot sits out before one
                      probe respawn.
    agents:           remote `AgentClient`s (or agent base URLs) — when
                      non-empty the fleet is remote: spawns go through
                      the agents and supervision is lease-based.
    remote_argv:      the `serve` argv spawned on an agent for every
                      remote (re)spawn.
    lease_misses:     consecutive failed heartbeats before an agent is
                      marked partitioned.
    agent_failover_s: how long a partition may last before its slots
                      fail over to the surviving agents.
    backoff_fn:       (attempt) -> seconds; injectable so tests collapse
                      the jittered waits.
    clock:            injectable monotonic clock for deterministic tests.
    """

    def __init__(self, spawn_fn: Callable[[], object], router,
                 initial=(), min_replicas: int = 1, max_replicas: int = 1,
                 poll_interval_s: float = 0.25,
                 max_restarts: int = 5, restart_window_s: float = 30.0,
                 quarantine_s: float = 60.0,
                 drain_timeout_s: float = 10.0,
                 agents=(), remote_argv=None,
                 lease_misses: int = 3, agent_failover_s: float = 30.0,
                 backoff_fn: Callable[[int], float] = backoff_seconds,
                 clock=time.monotonic):
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.spawn_fn = spawn_fn
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.poll_interval_s = float(poll_interval_s)
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.quarantine_s = float(quarantine_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.remote_argv = list(remote_argv) if remote_argv else None
        self.lease_misses = int(lease_misses)
        self.agent_failover_s = float(agent_failover_s)
        self.backoff_fn = backoff_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._slots: List[_Slot] = []
        self._agents: List[_AgentState] = [_AgentState(a) for a in agents]
        self._agent_rr = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._restarts_total = 0
        self._spawn_failures_total = 0
        self._quarantines_total = 0
        for handle in initial:
            slot = _Slot(len(self._slots))
            slot.handle = handle
            slot.url = handle.url
            slot.summary = getattr(handle, "summary", None)
            slot.state = "running"
            # a RemoteReplicaHandle carries its AgentClient: bind the
            # slot to the matching lease so partitions find it
            client = getattr(handle, "client", None)
            if client is not None:
                ast = self._agent_for(client)
                slot.agent = ast
                slot.host = ast.host
            self._slots.append(slot)

    def _agent_for(self, client) -> _AgentState:
        for ast in self._agents:
            if ast.client is client or ast.url == getattr(client, "url",
                                                          None):
                return ast
        ast = _AgentState(client)
        self._agents.append(ast)
        return ast

    # -- spawning ------------------------------------------------------------
    def _pick_agent_locked(self) -> Optional[_AgentState]:
        """Next leased agent, round-robin; None when every agent is
        partitioned (the caller re-backoffs).  Caller holds `_lock`."""
        leased = [a for a in self._agents if a.state == "leased"]
        if not leased:
            return None
        agent = leased[self._agent_rr % len(leased)]
        self._agent_rr += 1
        return agent

    def _spawn_into(self, slot: _Slot) -> bool:
        """(Re)fill `slot` with a fresh process and put its URL in
        rotation.  Called WITHOUT `_lock` held (spawning blocks on
        warmup; router registration takes the router's lock).  Returns
        False — and books the death — when the spawn itself fails.

        Remote fleets spawn through an agent: the slot's own agent when
        its lease is good, otherwise the next leased agent round-robin
        (this is the failover path landing on a surviving host)."""
        agent: Optional[_AgentState] = None
        if self._agents:
            with self._lock:
                agent = slot.agent if (slot.agent is not None
                                       and slot.agent.state == "leased") \
                    else self._pick_agent_locked()
                if agent is None:
                    # every agent is partitioned: nothing to spawn ON;
                    # stay in backoff and retry when a lease comes back
                    slot.state = "backoff"
                    slot.next_spawn_at = self._clock() + self.backoff_fn(
                        max(slot.attempt, 1))
                    return False
        try:
            faults.fire("supervisor.spawn", slot=slot.id)
            if agent is not None:
                handle = agent.client.spawn(self.remote_argv)
            else:
                handle = self.spawn_fn()
            summary = handle.wait_ready()
        except BaseException as e:  # noqa: BLE001 — incl. SystemExit from
            # wait_ready on a child that died during startup: a spawn
            # failure is a death, never a supervisor crash
            now = self._clock()
            with self._lock:
                self._spawn_failures_total += 1
                slot.attempt += 1
                slot.deaths.append(now)
                slot.last_exit = None
                self._schedule_locked(slot, now, reason=str(e))
            return False
        url = handle.url
        with self._lock:
            slot.handle = handle
            slot.url = url
            slot.summary = summary
            slot.state = "running"
            slot.next_spawn_at = None
            slot.quarantined_at = None
            slot.attempt = 0
            if agent is not None:
                slot.agent = agent
                slot.host = agent.host
            host = slot.host
        self.router.add_replica(url, host=host)
        return True

    def _schedule_locked(self, slot: _Slot, now: float,
                         reason: str = "") -> None:
        """Decide what happens to a slot that just lost its process:
        backoff-respawn, or quarantine when it is crash-looping.
        Caller holds `_lock`."""
        horizon = now - self.restart_window_s
        while slot.deaths and slot.deaths[0] <= horizon:
            slot.deaths.popleft()
        if len(slot.deaths) >= self.max_restarts:
            slot.state = "quarantined"
            slot.quarantined_at = now
            slot.next_spawn_at = now + self.quarantine_s
            self._quarantines_total += 1
        else:
            slot.state = "backoff"
            slot.next_spawn_at = now + self.backoff_fn(
                max(slot.attempt, 1))

    # -- the lease machinery (remote fleets) ----------------------------------
    def _tick_agents(self, now: float) -> None:
        """One lease pass: heartbeat every agent (network, OUTSIDE
        `_lock`), then apply partition / failover / heal+reconcile
        transitions under `_lock`, then do the router mutations and
        orphan stops outside it again (lock ordering)."""
        if not self._agents:
            return
        beats = []
        for ast in self._agents:
            try:
                # an armed 'raise' here IS a partition: the agent stays
                # healthy, only the supervisor's view of it goes dark
                faults.fire("agent.partition", agent=ast.url)
                beats.append((ast, ast.client.refresh()))
            except Exception:  # noqa: BLE001 — unreachable/armed: a
                beats.append((ast, None))  # missed heartbeat, not a crash
        to_remove: List[str] = []
        to_add: List[tuple] = []           # (url, host)
        orphan_stops: List[tuple] = []     # (client, rid)
        with self._lock:
            for ast, records in beats:
                if records is None:
                    ast.missed += 1
                    if (ast.state == "leased"
                            and ast.missed >= self.lease_misses):
                        ast.state = "partitioned"
                        ast.partitioned_at = now
                        ast.partitions_total += 1
                        for slot in self._slots:
                            if slot.agent is ast and \
                                    slot.state == "running":
                                slot.state = "partitioned"
                                if slot.url:
                                    to_remove.append(slot.url)
                    if (ast.state == "partitioned"
                            and now - ast.partitioned_at
                            >= self.agent_failover_s):
                        # the host is lost as far as the fleet cares:
                        # fail its slots over to the surviving agents
                        for slot in self._slots:
                            if slot.agent is ast and \
                                    slot.state == "partitioned":
                                ast.failovers_total += 1
                                slot.attempt += 1
                                slot.deaths.append(now)
                                slot.last_exit = None
                                slot.handle = None
                                slot.agent = None
                                self._schedule_locked(slot, now)
                    continue
                healed = ast.state == "partitioned"
                ast.state = "leased"
                ast.missed = 0
                ast.last_ok = now
                ast.replicas_live = sum(1 for r in records
                                        if r.get("alive"))
                if healed:
                    adds, stops = self._reconcile_locked(ast, records,
                                                         now)
                    to_add.extend(adds)
                    orphan_stops.extend(stops)
        for url in to_remove:
            self.router.remove_replica(url)
        for url, host in to_add:
            if self.router.find_replica(url) is None:
                self.router.add_replica(url, host=host)
        for client, rid in orphan_stops:
            try:
                client.stop(rid, wait=False)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass

    def _reconcile_locked(self, ast: _AgentState, records, now: float):
        """Re-acquired lease: align the agent's ACTUAL replica set with
        the supervisor's intent.  Still-live replicas are adopted back
        (never respawned — that is the zero-double-spawn guarantee),
        dead ones book a normal death, and live agent children no slot
        intends anymore (failed over during the partition) are stopped.
        Caller holds `_lock`; returns (router adds, orphan stops) for
        the caller to apply outside it."""
        ast.reconciles_total += 1
        by_id = {r.get("id"): r for r in records}
        held = set()
        adds: List[tuple] = []
        for slot in self._slots:
            if slot.agent is not ast or slot.handle is None:
                continue
            rid = getattr(slot.handle, "rid", None)
            held.add(rid)
            if slot.state != "partitioned":
                continue
            rec = by_id.get(rid)
            if rec is not None and rec.get("alive"):
                slot.state = "running"
                ast.adopted_total += 1
                if slot.url:
                    adds.append((slot.url, ast.host))
            else:
                # died while we could not see it: a normal death, seen
                # late — book it and let the backoff machinery respawn
                slot.last_exit = (rec or {}).get("exit_code")
                slot.attempt += 1
                slot.deaths.append(now)
                slot.handle = None
                self._schedule_locked(slot, now)
        stops = [(ast.client, r.get("id")) for r in records
                 if r.get("alive") and r.get("id") not in held]
        ast.orphans_stopped_total += len(stops)
        return adds, stops

    # -- the supervision loop -------------------------------------------------
    def tick(self) -> None:
        """One supervision pass: heartbeat the agent leases, reap
        deaths, start due respawns.  Public so tests drive it
        deterministically; the background thread just calls it on
        `poll_interval_s`."""
        now = self._clock()
        # leases first: the heartbeat refreshes every remote handle's
        # exit-code snapshot, so the poll loop below reads fresh state
        self._tick_agents(now)
        dead: List[_Slot] = []
        due: List[_Slot] = []
        with self._lock:
            for slot in self._slots:
                if slot.state == "running":
                    rc = slot.handle.poll() if slot.handle is not None else 0
                    if rc is not None:
                        slot.last_exit = rc
                        slot.attempt += 1
                        slot.deaths.append(now)
                        self._schedule_locked(slot, now)
                        dead.append(slot)
                elif slot.state in ("backoff", "quarantined"):
                    if (slot.next_spawn_at is not None
                            and now >= slot.next_spawn_at):
                        due.append(slot)
        # router mutation + respawns happen OUTSIDE _lock (lock
        # ordering; spawns block on replica warmup)
        for slot in dead:
            if slot.url:
                self.router.remove_replica(slot.url)
        for slot in due:
            if self._spawn_into(slot):
                with self._lock:
                    slot.restarts += 1
                    self._restarts_total += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.tick()

    # -- scaling (the autoscaler's verbs) -------------------------------------
    def running_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s.state == "running")

    def scale_up(self) -> bool:
        """Add one replica (bounded by `max_replicas`); blocks on its
        warmup — which is seconds, not compiles, because it reads the
        shared warmed disk cache.  Returns True when a replica joined
        the rotation."""
        with self._lock:
            live = sum(1 for s in self._slots
                       if s.state in ("running", "backoff"))
            if live >= self.max_replicas:
                return False
            slot = next((s for s in self._slots if s.state == "stopped"),
                        None)
            if slot is None:
                slot = _Slot(len(self._slots))
                self._slots.append(slot)
            slot.state = "backoff"  # claimed: a concurrent tick skips it
            slot.next_spawn_at = None
        return self._spawn_into(slot)

    def scale_down(self) -> bool:
        """Remove one replica without dropping a single request: pick
        the emptiest RUNNING replica on the MOST-LOADED host (highest
        total last-polled queue depth) — shrinking the hot failure
        domain first keeps load spread across hosts — pull it from
        rotation FIRST, then SIGTERM: its own graceful drain answers
        everything already accepted.  Refuses below `min_replicas`.
        Single-host fleets degenerate to plain emptiest-replica."""
        with self._lock:
            running = [s for s in self._slots if s.state == "running"]
            if len(running) <= self.min_replicas:
                return False

            def queue_depth(slot: _Slot) -> int:
                rep = self.router.find_replica(slot.url or "")
                st = rep.last_stats if rep is not None else None
                if not st:
                    return 0
                return sum(p.get("queue_depth", 0)
                           for p in st.get("priorities", {}).values())

            by_host: Dict[str, List[_Slot]] = {}
            for s in running:
                by_host.setdefault(s.host, []).append(s)
            target = max(by_host.values(),
                         key=lambda group: sum(queue_depth(s)
                                               for s in group))
            victim = min(target, key=queue_depth)
            victim.state = "draining"  # off-limits to tick() reaping
        self.router.remove_replica(victim.url)
        handle = victim.handle
        rc: Optional[int] = None
        if handle is not None:
            handle.terminate()
            try:
                rc = handle.wait(timeout=self.drain_timeout_s + 15.0)
            except Exception:  # noqa: BLE001 — wedged: escalate
                handle.kill()
                rc = handle.wait()
        with self._lock:
            victim.state = "stopped"
            victim.handle = None
            victim.last_exit = rc
        return True

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dl4j-fleet-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop supervising (no more reaps/respawns).  Does NOT touch
        the replica processes — the CLI drains the router first and
        then terminates the handles this supervisor reports."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_interval_s * 4 + 1.0)

    def handles(self) -> List[object]:
        """Live process handles for the CLI's final SIGTERM sweep."""
        with self._lock:
            return [s.handle for s in self._slots if s.handle is not None]

    # -- observability --------------------------------------------------------
    def stats(self) -> dict:
        now = self._clock()
        with self._lock:
            states = {s: 0 for s in STATES}
            states["draining"] = 0
            for slot in self._slots:
                states[slot.state] = states.get(slot.state, 0) + 1
            return {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "states": states,
                "restarts_total": self._restarts_total,
                "spawn_failures_total": self._spawn_failures_total,
                "quarantines_total": self._quarantines_total,
                "partitions_total": sum(a.partitions_total
                                        for a in self._agents),
                "failovers_total": sum(a.failovers_total
                                       for a in self._agents),
                "adopted_total": sum(a.adopted_total
                                     for a in self._agents),
                "agents": [a.describe() for a in self._agents],
                "slots": [s.describe(now) for s in self._slots],
            }

"""Signal-driven fleet autoscaling between --min-replicas and
--max-replicas.

The signals are the ones the router's health poller already collects
from every replica's /v1/stats — the same numbers the Prometheus
families export (queue depth, p99 latency, breaker state, degraded
batches) — so the autoscaler needs no new data path: it reads the
router's cached per-replica stats, decides, and acts through the
supervisor's `scale_up()` / `scale_down()` verbs.

Decision shape (the classic utilization controller, made boring on
purpose):

  up    when per-replica queue depth exceeds `up_queue_per_replica`, OR
        fleet p99 exceeds the SLO, OR any replica's execute breaker is
        open / its batcher served degraded batches since the last look —
        the fleet is saturated or sick, add capacity.  Scale-up warms
        from the shared disk compile cache, so a new replica costs
        seconds of process start, not minutes of XLA compiles.
  down  when per-replica queue depth is under `down_queue_per_replica`
        AND p99 is comfortably inside the SLO (half, by default) AND
        nothing is degraded — the fleet is idle, shed capacity.  The
        supervisor drains the emptiest replica before SIGTERM, so
        shrinking provably drops zero requests.
  hold  otherwise.

Two dampers keep it from flapping (the failure mode of every naive
autoscaler): a raw up/down signal must persist for `consecutive`
evaluations before it acts (hysteresis — one spiky scrape does
nothing), and after any action the controller holds for `cooldown_s`
(the fleet needs time to show the effect of the last change before it
is judged again).

Deterministic by construction: `evaluate_once()` is the whole control
step and the clock is injectable, so tests drive decisions without
sleeping; `start()` merely calls it on a timer thread.

The port's own copy of `deeplearning4j_tpu/serving/autoscaler.py`.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

#: decision labels (exported as dl4j_autoscaler_decisions_total{decision=}).
#: `hold_partitioned` is a scale-up the controller REFUSED because slots
#: are partitioned: the capacity still exists on the far side of a
#: network partition, and spawning more would double it the moment the
#: partition heals.
DECISIONS = ("scale_up", "scale_down", "hold", "hold_partitioned")


class Autoscaler:
    """Grow/shrink the supervised fleet from router-polled signals.

    router / supervisor:   the data path and the actuator.
    slo_p99_ms:            the latency objective; fleet p99 above it is
                           a scale-up signal, p99 under half of it is
                           (part of) a scale-down signal.
    up_queue_per_replica / down_queue_per_replica: queue-depth
                           thresholds, per running replica.
    consecutive:           evaluations a raw signal must persist before
                           acting (hysteresis).
    cooldown_s:            hold-down after any scaling action.
    interval_s:            evaluation cadence of the background thread.
    """

    def __init__(self, router, supervisor, slo_p99_ms: float = 500.0,
                 up_queue_per_replica: float = 8.0,
                 down_queue_per_replica: float = 1.0,
                 consecutive: int = 3, cooldown_s: float = 10.0,
                 interval_s: float = 1.0, clock=time.monotonic):
        self.router = router
        self.supervisor = supervisor
        self.slo_p99_ms = float(slo_p99_ms)
        self.up_queue_per_replica = float(up_queue_per_replica)
        self.down_queue_per_replica = float(down_queue_per_replica)
        self.consecutive = int(consecutive)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._streak_dir = "hold"
        self._streak = 0
        self._cooldown_until = 0.0
        self._last_degraded: Optional[int] = None
        self._decisions = {d: 0 for d in DECISIONS}
        self._last_signals: dict = {}

    # -- signals ---------------------------------------------------------------
    def signals(self) -> dict:
        """One consistent look at the fleet, from the router's cached
        (fresh, non-stale) per-replica stats — no extra HTTP."""
        staleness = getattr(self.router, "stats_staleness_s", 10.0)
        queue_depth = 0
        p99_ms = 0.0
        degraded = 0
        breaker_open = False
        healthy = 0
        for rep in self.router.replicas:
            if not rep.ready or rep.stale(staleness):
                continue
            healthy += 1
            st = rep.last_stats or {}
            for ps in st.get("priorities", {}).values():
                queue_depth += ps.get("queue_depth", 0)
            p99_ms = max(p99_ms,
                         (st.get("latency_ms", {}) or {}).get("p99", 0.0))
            degraded += st.get("degraded_batches", 0)
            if (st.get("breaker", {}) or {}).get("state") == "open":
                breaker_open = True
        stats_fn = getattr(self.supervisor, "stats", None)
        partitioned = (stats_fn().get("states", {}).get("partitioned", 0)
                       if stats_fn is not None else 0)
        return {"healthy_replicas": healthy, "queue_depth": queue_depth,
                "p99_ms": p99_ms, "degraded_batches": degraded,
                "breaker_open": breaker_open,
                "partitioned_slots": partitioned}

    def _raw_direction(self, sig: dict) -> str:
        n = max(sig["healthy_replicas"], 1)
        degraded_grew = (self._last_degraded is not None
                         and sig["degraded_batches"] > self._last_degraded)
        self._last_degraded = sig["degraded_batches"]
        if (sig["queue_depth"] / n > self.up_queue_per_replica
                or sig["p99_ms"] > self.slo_p99_ms
                or sig["breaker_open"] or degraded_grew):
            return "scale_up"
        if (sig["queue_depth"] / n < self.down_queue_per_replica
                and sig["p99_ms"] < 0.5 * self.slo_p99_ms
                and not sig["breaker_open"]):
            return "scale_down"
        return "hold"

    # -- the control step ------------------------------------------------------
    def evaluate_once(self) -> str:
        """One full control step: read signals, apply hysteresis and
        cooldown, act through the supervisor.  Returns the decision
        actually taken (`hold` includes cooldown and streak-building)."""
        now = self._clock()
        sig = self.signals()
        with self._lock:
            self._last_signals = sig
            raw = self._raw_direction(sig)
            if now < self._cooldown_until:
                # cooldown freezes the controller entirely — the streak
                # must rebuild from scratch afterwards, so the fleet
                # gets `consecutive` clean looks at the effect of the
                # last action before being judged again
                self._streak_dir, self._streak = "hold", 0
                act = "hold"
            else:
                if raw == self._streak_dir:
                    self._streak += 1
                else:
                    self._streak_dir = raw
                    self._streak = 1
                act = (raw if raw != "hold"
                       and self._streak >= self.consecutive else "hold")
            if act == "scale_up" and sig.get("partitioned_slots", 0) > 0:
                # partitioned capacity is unreachable, NOT gone: growing
                # now would double it when the lease heals and the
                # supervisor adopts the replicas back.  Count the refusal
                # (no cooldown — the moment the partition resolves, the
                # built streak may act).
                act = "hold_partitioned"
            self._decisions[act] += 1
            if act in ("scale_up", "scale_down"):
                self._cooldown_until = now + self.cooldown_s
                self._streak = 0
                self._streak_dir = "hold"
        # actuate OUTSIDE the lock: scale_up blocks on a replica warmup,
        # scale_down blocks on a drain
        if act == "scale_up":
            if not self.supervisor.scale_up():
                act = "hold"  # already at max (raced another grower)
        elif act == "scale_down":
            if not self.supervisor.scale_down():
                act = "hold"  # already at min
        return act

    def target_replicas(self) -> int:
        """What the controller currently wants: the running count, plus
        or minus one when a streak is about to act."""
        running = self.supervisor.running_count()
        with self._lock:
            if self._streak_dir == "scale_up":
                return min(running + 1, self.supervisor.max_replicas)
            if self._streak_dir == "scale_down":
                return max(running - 1, self.supervisor.min_replicas)
        return running

    # -- lifecycle -------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — a failed evaluation must
                pass           # never kill the control loop

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dl4j-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 4 + 1.0)

    # -- observability ---------------------------------------------------------
    def stats(self) -> dict:
        target = self.target_replicas()
        with self._lock:
            return {
                "slo_p99_ms": self.slo_p99_ms,
                "decisions": dict(self._decisions),
                "streak": {"direction": self._streak_dir,
                           "length": self._streak},
                "cooldown_remaining_s": round(
                    max(self._cooldown_until - self._clock(), 0.0), 3),
                "signals": dict(self._last_signals),
                "target_replicas": target,
            }

"""Deterministic fault injection: named points that product code traverses
and that tests (or an operator, through ``DL4J_FAULT_PLAN``) arm to raise,
delay or corrupt on the Nth traversal.

The port's copy of `deeplearning4j_tpu/reliability/faults.py` (which
imports no jax): the same plan format, actions and point names, so a plan
armed for the JAX package arms the port. Points the port traverses:

  ``prefetch.worker``     per batch staged by `PrefetchIterator`
                          (datasets/iterator.py)
  ``compile``             per CUDA-graph capture (on the CPU, per new
                          program key) in the shared `CompiledProgramCache`
                          (optimize/step_cache.py)
  ``checkpoint.save``     atomic checkpoint write (parallel/checkpoint.py)
  ``checkpoint.load``     checkpoint read (parallel/checkpoint.py); an
                          armed raise simulates a torn or unreadable
                          directory, which `load_resilient` must skip

`DOCUMENTED_POINTS` keeps the JAX package's whole registry, so that names
stay one vocabulary across both packages. With nothing armed, `fire()` is a
counter bump under a lock.

Env hook: ``DL4J_FAULT_PLAN="point=action[:param][@nth][xTIMES],..."``
  actions: ``raise`` (FaultInjected), ``oserror``, ``ioerror``,
  ``timeout``, ``delay:SECONDS``, ``corrupt``.
  ``@nth`` = first traversal that fires (1-based, default 1);
  ``xTIMES`` = how many consecutive traversals fire (default 1).
Example:
``DL4J_FAULT_PLAN="checkpoint.save=raise@3,prefetch.worker=delay:0.1"``
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Dict, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")

#: monkeypatchable clock sleep used by the ``delay`` action
_sleep = time.sleep

ENV_VAR = "DL4J_FAULT_PLAN"

#: Every injection point of the JAX package's registry, by name (the
#: port traverses the four its module docstring lists).
DOCUMENTED_POINTS = {
    "prefetch.worker": "per batch produced by PrefetchIterator's "
                       "background thread (datasets/iterator.py)",
    "persist.read": "disk-cache entry read (optimize/persist.py)",
    "persist.write": "disk-cache entry write (optimize/persist.py); "
                     "'corrupt' flips payload bytes",
    "compile": "fresh trace+compile in the shared CompiledProgramCache "
               "(optimize/step_cache.py)",
    "dispatcher.execute": "per coalesced batch in the serving gateway's "
                          "dispatcher (serving/batcher.py)",
    "checkpoint.save": "atomic checkpoint write (parallel/checkpoint.py)",
    "checkpoint.load": "checkpoint read (parallel/checkpoint.py)",
    "trainer.step": "per batch in DataParallelTrainer.fit "
                    "(parallel/data_parallel.py)",
    "router.proxy": "per proxy attempt in Router.route_predict "
                    "(serving/router.py)",
    "router.poll": "per replica health poll (serving/router.py)",
    "supervisor.spawn": "per replica (re)spawn attempt in FleetSupervisor "
                        "(serving/supervisor.py)",
    "generate.admit": "per stream admission into a free decode slot in "
                      "ContinuousBatcher (serving/batcher.py)",
    "decode.step": "per active slot per decode-table step in "
                   "ContinuousBatcher (serving/batcher.py)",
    "decode.page_alloc": "per KV-page allocation in the paged decode "
                         "pool (serving/batcher.py)",
    "generate.prefix_lookup": "per prefix-cache probe during stream "
                              "admission (serving/batcher.py)",
    "pipeline.stage": "per pipeline schedule build (trace time) in "
                      "pipeline_apply (parallel/pipeline.py)",
    "expert.dispatch": "per expert-parallel dispatch build (trace time) "
                       "in moe_ffn (parallel/expert.py)",
    "tune.measure": "per candidate measurement in the autotuner search "
                    "(optimize/tune.py); a failure skips the candidate "
                    "(counted) and the search completes",
    "tune.load": "tuned-table read from the disk compile cache "
                 "(optimize/tunables.py); a failure degrades to registry "
                 "defaults with one warning — serving never blocks",
    "agent.spawn": "per remote replica spawn request sent to a "
                   "ReplicaAgent (serving/agent.py AgentClient.spawn)",
    "agent.poll": "per agent /a/replicas poll in AgentClient.refresh "
                  "(serving/agent.py); a failure counts as a missed "
                  "heartbeat toward the lease",
    "agent.cache_fetch": "per remote compile-cache entry download "
                         "(serving/cachesync.py); 'corrupt' flips the "
                         "fetched bytes so the checksum re-validation "
                         "path is testable",
    "agent.partition": "per agent lease heartbeat in FleetSupervisor "
                       "(serving/supervisor.py); arming 'raise' "
                       "simulates a network partition between the "
                       "supervisor and a healthy agent",
}

_PLAN_RE = re.compile(
    r"(?P<action>[a-z_]+)"
    r"(?::(?P<param>[0-9.]+))?"
    r"(?:@(?P<nth>[0-9]+))?"
    r"(?:x(?P<times>[0-9]+))?$")

_EXC_TYPES = {
    "raise": None,  # FaultInjected (resolved below; forward ref)
    "oserror": OSError,
    "ioerror": IOError,
    "timeout": TimeoutError,
}


class FaultInjected(RuntimeError):
    """Raised by an armed injection point (the default ``raise`` action)."""


class FaultPlanError(ValueError):
    """A ``DL4J_FAULT_PLAN`` / `arm()` spec could not be parsed."""


class _Plan:
    __slots__ = ("point", "action", "nth", "times", "exc", "delay_s",
                 "fired")

    def __init__(self, point, action, nth, times, exc, delay_s):
        self.point = point
        self.action = action
        self.nth = int(nth)
        self.times = int(times)
        self.exc = exc
        self.delay_s = float(delay_s)
        self.fired = 0

    def window(self, hit: int) -> bool:
        """Does traversal number `hit` (1-based) fall in the armed
        [nth, nth+times) window?"""
        return self.nth <= hit < self.nth + self.times

    def as_dict(self) -> dict:
        return {"action": self.action, "nth": self.nth, "times": self.times,
                "fired": self.fired}


def _corrupt_bytes(data: bytes) -> bytes:
    """Flip the leading bytes — enough to break any magic/checksum while
    keeping the length (a torn-length corruption is a different bug)."""
    n = min(64, len(data))
    return bytes(b ^ 0xFF for b in data[:n]) + data[n:]


class FaultRegistry:
    """Thread-safe registry of armed fault plans + per-point hit counts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: Dict[str, _Plan] = {}
        self._hits: Dict[str, int] = {}
        self._env_installed = False

    # -- arming -------------------------------------------------------------
    def arm(self, point: str, action: str = "raise", nth: int = 1,
            times: int = 1, exc=None, delay_s: float = 0.05) -> None:
        """Arm `point` to fire on its `nth` traversal (1-based) and the
        `times - 1` traversals after it.

        action: ``raise`` (FaultInjected or `exc`), ``oserror``,
        ``ioerror``, ``timeout``, ``delay`` (sleep `delay_s`), or
        ``corrupt`` (mutate the payload passed to `fire(data=...)`).
        Counting starts from the point's CURRENT hit count, so arming
        mid-run targets future traversals."""
        if action in _EXC_TYPES:
            exc = exc or _EXC_TYPES[action] or FaultInjected
        elif action not in ("delay", "corrupt"):
            raise FaultPlanError(f"unknown fault action {action!r}")
        with self._lock:
            base = self._hits.get(point, 0)
            self._plans[point] = _Plan(point, action, base + int(nth),
                                       times, exc, delay_s)

    def disarm(self, point: Optional[str] = None) -> None:
        """Disarm one point (or every point with None); hit counters
        keep counting."""
        with self._lock:
            if point is None:
                self._plans.clear()
            else:
                self._plans.pop(point, None)

    def reset(self) -> None:
        """Disarm everything and zero every hit counter (test teardown)."""
        with self._lock:
            self._plans.clear()
            self._hits.clear()
            self._env_installed = False

    # -- env hook -----------------------------------------------------------
    def install_env_plan(self, spec: Optional[str] = None) -> int:
        """Parse ``DL4J_FAULT_PLAN`` (or an explicit `spec`) and arm each
        entry; returns the number of plans armed.  Called lazily by the
        first `fire()`, so simply exporting the variable arms a process."""
        spec = os.environ.get(ENV_VAR, "") if spec is None else spec
        with self._lock:
            self._env_installed = True
        n = 0
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            point, sep, rest = part.partition("=")
            m = _PLAN_RE.match(rest.strip()) if sep else None
            if not point or m is None:
                raise FaultPlanError(
                    f"bad fault plan entry {part!r} (want "
                    f"point=action[:param][@nth][xTIMES])")
            action = m.group("action")
            kw = {"nth": int(m.group("nth") or 1),
                  "times": int(m.group("times") or 1)}
            if action == "delay":
                kw["delay_s"] = float(m.group("param") or 0.05)
            self.arm(point.strip(), action, **kw)
            n += 1
        if n:
            log.warning("fault plan armed from %s: %s", ENV_VAR, spec)
        return n

    # -- the injection point ------------------------------------------------
    def fire(self, point: str, data=None, **ctx):
        """Traverse injection point `point`.

        Returns `data` unchanged (the common case), a corrupted copy of
        it (``corrupt`` plans), or raises/delays per the armed plan.
        Product code calls this unconditionally; un-armed points only
        pay a lock + counter bump."""
        with self._lock:
            if not self._env_installed:
                self._lock.release()
                try:
                    self.install_env_plan()
                finally:
                    self._lock.acquire()
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            plan = self._plans.get(point)
            live = plan is not None and plan.window(hit)
            if live:
                plan.fired += 1
        if not live:
            return data
        log.warning("fault injected at %s (hit %d, action %s)%s",
                    point, hit, plan.action,
                    f" ctx={ctx}" if ctx else "")
        if plan.action == "delay":
            _sleep(plan.delay_s)
            return data
        if plan.action == "corrupt":
            if isinstance(data, (bytes, bytearray)):
                return _corrupt_bytes(bytes(data))
            # no corruptible payload at this site — fail loudly rather
            # than silently doing nothing
            raise FaultInjected(
                f"corrupt armed at {point} but fire() got no bytes payload")
        raise plan.exc(f"injected fault at {point} (hit {hit})")

    # -- observability ------------------------------------------------------
    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": dict(self._hits),
                "armed": {p: plan.as_dict()
                          for p, plan in self._plans.items()},
            }


#: process-wide registry — product code and tests share one instance
REGISTRY = FaultRegistry()

# module-level conveniences (the public API)
arm = REGISTRY.arm
disarm = REGISTRY.disarm
reset = REGISTRY.reset
fire = REGISTRY.fire
hits = REGISTRY.hits
stats = REGISTRY.stats
install_env_plan = REGISTRY.install_env_plan

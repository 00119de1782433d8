"""Circuit breaker for the serving gateway's execute path.

The port's own copy of `deeplearning4j_tpu/reliability/circuit.py`.
Classic three-state machine (CLOSED → OPEN → HALF_OPEN) with
probabilistic half-open probes: after `reset_timeout_s` in OPEN, each
`allow()` call flips a biased coin (`probe_prob`) so only a fraction of
traffic probes the primary path while the rest keeps taking the
degraded fallback — a thundering herd of probes against a still-broken
backend is itself an outage amplifier.

Clock and RNG are injectable so tests drive the state machine
deterministically without sleeping.
"""

from __future__ import annotations

import random
import threading
import time


class CircuitBreaker:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    #: numeric encoding for metrics exporters (Prometheus gauges carry
    #: floats, not strings): closed=0, open=1, half_open=2
    STATE_CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 5.0, probe_prob: float = 0.5,
                 clock=time.monotonic, rng=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.probe_prob = float(probe_prob)
        self._clock = clock
        self._rng = rng if rng is not None else random.Random(0)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        # counters for /v1/stats
        self._opens = 0
        self._probes = 0
        self._successes = 0
        self._failures = 0

    # -- queries ------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = self.HALF_OPEN
        return self._state

    @property
    def state_code(self) -> int:
        """`STATE_CODES[self.state]`: the breaker gauge's value in
        /metrics."""
        return self.STATE_CODES[self.state]

    def allow(self) -> bool:
        """May this call try the primary path?  CLOSED: always.
        OPEN: never (until the reset timeout).  HALF_OPEN: with
        probability `probe_prob` (the probe)."""
        with self._lock:
            state = self._state_locked()
            if state == self.CLOSED:
                return True
            if state == self.OPEN:
                return False
            probe = self._rng.random() < self.probe_prob
            if probe:
                self._probes += 1
            return probe

    # -- outcome reporting ---------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            self._successes += 1
            self._consecutive_failures = 0
            self._state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            state = self._state_locked()
            if state == self.HALF_OPEN:
                # the probe failed: straight back to OPEN, restart cooldown
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._opens += 1
                return
            self._consecutive_failures += 1
            if (state == self.CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._opens += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state_locked(),
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "opens": self._opens,
                "probes": self._probes,
                "successes": self._successes,
                "failures": self._failures,
            }

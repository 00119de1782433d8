"""Retry budget: a fleet-level brake on retry/hedge amplification.

A retry (or a hedged duplicate) is cheap insurance for one request and
an outage amplifier for a fleet: when every request retries into a
brown-out, offered load doubles exactly when capacity halved — the
classic retry storm.  `RetryBudget` bounds the EXTRA attempts a caller
may add to a trailing window of primary requests: spending is allowed
while

    extra_attempts_in_window < max(min_tokens, ratio * requests_in_window)

so a lone failure always gets its `min_tokens` retries, a busy healthy
fleet gets `ratio` (e.g. 10%) headroom for hedges and fail-overs, and a
full brown-out degrades every caller to single-attempt instead of
storming.  The shape follows the gRPC/Finagle retry-budget design.

Thread-safe; clock injectable so tests drive the window without
sleeping.

The port's own copy of `deeplearning4j_tpu/reliability/budget.py`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque


class RetryBudget:
    """Sliding-window token budget shared by retries and hedges.

    ratio:      extra attempts allowed per primary request in the window.
    min_tokens: floor so low-traffic callers can still retry at all.
    window_s:   trailing window the ratio is computed over.
    """

    def __init__(self, ratio: float = 0.1, min_tokens: int = 3,
                 window_s: float = 10.0, clock=time.monotonic):
        if ratio < 0.0:
            raise ValueError("ratio must be >= 0")
        self.ratio = float(ratio)
        self.min_tokens = int(min_tokens)
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._requests: Deque[float] = deque()
        self._spends: Deque[float] = deque()
        # lifetime counters for /v1/stats and Prometheus
        self._requests_total = 0
        self._spent_total = 0
        self._exhausted_total = 0

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._requests and self._requests[0] <= horizon:
            self._requests.popleft()
        while self._spends and self._spends[0] <= horizon:
            self._spends.popleft()

    def note_request(self) -> None:
        """Record one primary request (NOT a retry) entering the system;
        this is what earns the window its retry tokens."""
        now = self._clock()
        with self._lock:
            self._prune_locked(now)
            self._requests.append(now)
            self._requests_total += 1

    def _allowance_locked(self) -> float:
        return max(float(self.min_tokens), self.ratio * len(self._requests))

    def try_spend(self) -> bool:
        """Spend one token for an extra attempt (retry or hedge).
        False — and counted as an exhaustion — when the window's
        allowance is used up: the caller must fall through to
        single-attempt, never queue-and-wait."""
        now = self._clock()
        with self._lock:
            self._prune_locked(now)
            if len(self._spends) >= self._allowance_locked():
                self._exhausted_total += 1
                return False
            self._spends.append(now)
            self._spent_total += 1
            return True

    def remaining(self) -> float:
        with self._lock:
            self._prune_locked(self._clock())
            return max(self._allowance_locked() - len(self._spends), 0.0)

    def stats(self) -> dict:
        with self._lock:
            self._prune_locked(self._clock())
            allowance = self._allowance_locked()
            return {
                "ratio": self.ratio,
                "min_tokens": self.min_tokens,
                "window_s": self.window_s,
                "requests_in_window": len(self._requests),
                "spent_in_window": len(self._spends),
                "remaining": round(max(allowance - len(self._spends), 0.0),
                                   3),
                "requests_total": self._requests_total,
                "spent_total": self._spent_total,
                "exhausted_total": self._exhausted_total,
            }

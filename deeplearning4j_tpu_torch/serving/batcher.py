"""Dynamic micro-batching: many concurrent requests, one device call.

Counterpart of `MicroBatcher` in `deeplearning4j_tpu/serving/batcher.py`
(the predict path; continuous batching for generation is not ported yet).
Requests land on a per-(feature shape, dtype) FIFO from any thread, and one
dispatcher thread drains them into a single `net.output()` call.

Flush policy: the queued rows reach the target batch (`max_batch_rows`,
else `DEFAULT_TARGET_ROWS`), or the oldest queued request has waited
`max_delay_ms`. Requests past their `deadline_ms` are answered
`DeadlineExceeded` before they are batched. "interactive" requests are
queued ahead of "batch" ones. The queue is bounded by `max_pending`;
beyond it `predict()` raises `ServerOverloaded`.

Each request gets its own rows of the batch's output. A sequence model's
output has several rows per input row (the charTransformer's `rnn_to_ff`
head gives [rows * S, vocab]), so request i gets
`out[offset * k : (offset + rows) * k]` with `k = out.shape[0] // batch
rows`. (The JAX package's batcher slices `out[offset : offset + rows]`,
which is wrong for such models.)

A `CircuitBreaker` guards `net.output`, which replays the network's
captured inference graph (`optimize/infer_cache.py`); while the breaker is
open, batches run through the eager `network_output` on the same device and
weights, a path that shares no graph, static buffer or memory pool with
the primary one.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.reliability import (CircuitBreaker,
                                                  DeadlineExceeded)

#: coalescing target in rows when the caller sets no `max_batch_rows` (the
#: JAX package's registry default; not yet measured on a GPU)
DEFAULT_TARGET_ROWS = 256

#: flush deadline when the caller sets no `max_delay_ms` (the JAX package's
#: registry default; not yet measured on a GPU)
DEFAULT_MAX_DELAY_MS = 3.0

#: rows/s is reported over this trailing window (seconds)
RATE_WINDOW_S = 10.0

#: request priority classes, highest first
PRIORITIES = ("interactive", "batch")


class ServerOverloaded(RuntimeError):
    """The gateway's pending queue is full — fail fast (HTTP 503)."""


class _Pending:
    """One enqueued request: its rows, completion event, and timing."""

    __slots__ = ("x", "rows", "done", "result", "error", "t_enqueue",
                 "deadline", "priority")

    def __init__(self, x, deadline_ms: Optional[float], priority: str):
        self.x = x
        self.rows = int(x.shape[0])
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.monotonic()
        self.deadline = (None if deadline_ms is None
                         else self.t_enqueue + float(deadline_ms) / 1000.0)
        self.priority = priority


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class MicroBatcher:
    """Coalesces concurrent predict requests into one device call each
    flush. `net` is a `MultiLayerNetwork`; see the module docstring for the
    other arguments."""

    def __init__(self, net, max_delay_ms: Optional[float] = None,
                 max_pending: int = 1024,
                 max_batch_rows: Optional[int] = None,
                 auto_start: bool = True,
                 breaker: Optional[CircuitBreaker] = None):
        self.net = net
        if max_delay_ms is None:
            max_delay_ms = DEFAULT_MAX_DELAY_MS
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.max_pending = int(max_pending)
        self.target_rows = int(max_batch_rows or DEFAULT_TARGET_ROWS)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._auto_start = auto_start
        self._cv = threading.Condition()
        # key = (feature shape beyond axis 0, dtype): only requests that
        # concatenate into one batch share a queue
        self._queues: Dict[Tuple, Deque[_Pending]] = {}
        self._pending = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # -- stats (guarded by _cv's lock) ---------------------------------
        self._t_start = time.monotonic()
        self._reqs_done = 0
        self._rows_done = 0
        self._batch_hist: Dict[int, int] = {}   # flushed batch rows -> count
        self._latencies: Deque[float] = deque(maxlen=4096)  # seconds
        self._recent: Deque[Tuple[float, int]] = deque()    # (t_done, rows)
        self._deadline_misses = 0
        self._errors = 0
        self._degraded_batches = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        with self._cv:
            if self._thread is not None:
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="dl4j-torch-microbatch",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the dispatcher; queued requests are served before the
        thread exits."""
        with self._cv:
            self._stop = True
            thread, self._thread = self._thread, None
            self._cv.notify_all()
        if thread is not None:
            thread.join(timeout=timeout)

    # -- request side (any thread) ------------------------------------------
    def predict(self, x, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None,
                priority: str = "interactive") -> np.ndarray:
        """Enqueue `x` ([rows, ...features]) and block until its output
        rows come back from a coalesced device call.

        Raises `ValueError` for input the network cannot take
        (`net.check_input`), `ServerOverloaded` when `max_pending` requests are queued,
        `DeadlineExceeded` when `deadline_ms` elapses first, and
        `TimeoutError` past `timeout` seconds."""
        x = np.asarray(x)
        if x.ndim < 2:
            raise ValueError(
                f"predict expects batched input [rows, ...features]; "
                f"got shape {x.shape}")
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}; got {priority!r}")
        self.net.check_input(x)
        if deadline_ms is not None and float(deadline_ms) <= 0.0:
            with self._cv:
                self._deadline_misses += 1
            raise DeadlineExceeded(
                f"deadline_ms={deadline_ms} already expired at enqueue")
        req = _Pending(x, deadline_ms, priority)
        key = (x.shape[1:], str(x.dtype))
        with self._cv:
            if self._pending >= self.max_pending:
                raise ServerOverloaded(
                    f"{self._pending} requests already pending "
                    f"(max_pending={self.max_pending})")
            q = self._queues.setdefault(key, deque())
            if priority == "batch" or not q or q[-1].priority != "batch":
                q.append(req)
            else:
                # interactive requests go ahead of the queued batch ones
                i = 0
                while i < len(q) and q[i].priority != "batch":
                    i += 1
                q.insert(i, req)
            self._pending += 1
            self._cv.notify_all()
        if self._thread is None and self._auto_start:
            self.start()
        if not req.done.wait(timeout):
            raise TimeoutError(
                f"no response within {timeout}s (queue depth "
                f"{self.queue_depth()})")
        if req.error is not None:
            raise req.error
        return req.result

    def queue_depth(self) -> int:
        with self._cv:
            return self._pending

    # -- dispatcher (one thread) --------------------------------------------
    def _oldest_key(self):
        """The queue whose head has waited longest (FIFO across shapes).
        Caller holds `_cv`."""
        heads = [(q[0].t_enqueue, key) for key, q in self._queues.items()
                 if q]
        return min(heads, key=lambda h: h[0])[1] if heads else None

    def _evict_expired_locked(self, now: float) -> None:
        """Answer every queued request past its deadline with
        `DeadlineExceeded` before it is batched. Caller holds `_cv`."""
        for q in self._queues.values():
            expired = [r for r in q
                       if r.deadline is not None and r.deadline <= now]
            for r in expired:
                q.remove(r)
                self._pending -= 1
                self._deadline_misses += 1
                self._errors += 1
                r.error = DeadlineExceeded(
                    f"deadline exceeded after "
                    f"{(now - r.t_enqueue) * 1e3:.1f}ms in queue")
                r.done.set()

    def _earliest_deadline_locked(self) -> Optional[float]:
        dls = [r.deadline for q in self._queues.values() for r in q
               if r.deadline is not None]
        return min(dls) if dls else None

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                now = time.monotonic()
                self._evict_expired_locked(now)
                key = self._oldest_key()
                if key is None:
                    if self._stop:
                        return
                    self._cv.wait()
                    continue
                q = self._queues[key]
                queued_rows = sum(r.rows for r in q)
                flush_at = min(r.t_enqueue for r in q) + self.max_delay_s
                # stopping: drain immediately rather than wait
                if (queued_rows < self.target_rows and now < flush_at
                        and not self._stop):
                    edl = self._earliest_deadline_locked()
                    wake_at = flush_at if edl is None else min(flush_at, edl)
                    self._cv.wait(timeout=max(wake_at - now, 1e-4))
                    continue
                batch = [q.popleft()]
                rows = batch[0].rows
                while q and rows + q[0].rows <= self.target_rows:
                    batch.append(q.popleft())
                    rows += batch[-1].rows
                self._pending -= len(batch)
            self._execute(batch)

    # -- execution paths -----------------------------------------------------
    def _primary_output(self, xb: np.ndarray) -> np.ndarray:
        """`net.output` on the batch (on CUDA, a replay of the infer cache's
        graph for the batch's bucket); guarded by the circuit breaker."""
        return self.net.output(xb).float().cpu().numpy()

    def _degraded_output(self, xb: np.ndarray) -> np.ndarray:
        """The fallback while the breaker is open: the eager
        `network_output` on the network's own device and weights, without
        the infer cache, so a fault in a capture, a replay or the graphs'
        memory pool does not reach it."""
        import torch

        from deeplearning4j_tpu_torch.nn.multilayer import network_output

        with torch.inference_mode():
            x = torch.as_tensor(xb).to(self.net.device)
            return network_output(self.net.conf, self.net.params,
                                  x).float().cpu().numpy()

    def _execute(self, batch: List[_Pending]) -> None:
        xs = [r.x for r in batch]
        xb = xs[0] if len(xs) == 1 else np.concatenate(xs, axis=0)
        out, err, degraded = None, None, False
        if self.breaker.allow():
            try:
                out = self._primary_output(xb)
                self.breaker.record_success()
            except Exception as e:  # noqa: BLE001 — degrade, then report
                self.breaker.record_failure()
                err = e
        else:
            err = RuntimeError("circuit breaker open")
        if out is None:
            try:
                out = self._degraded_output(xb)
                degraded, err = True, None
            except Exception as e:  # noqa: BLE001 — delivered per request
                err = err if err is not None else e
                out = None
        t_done = time.monotonic()
        # output rows per input row: 1 for a classifier, S for a sequence
        # model whose head flattens [rows, S, F] to [rows * S, F]
        k = 0 if out is None else out.shape[0] // xb.shape[0]
        offset = 0
        for r in batch:
            if err is not None:
                r.error = err
            else:
                r.result = out[offset * k:(offset + r.rows) * k]
                offset += r.rows
            r.done.set()
        with self._cv:
            rows = sum(r.rows for r in batch)
            self._reqs_done += len(batch)
            self._rows_done += rows
            self._batch_hist[rows] = self._batch_hist.get(rows, 0) + 1
            self._recent.append((t_done, rows))
            while self._recent and t_done - self._recent[0][0] > RATE_WINDOW_S:
                self._recent.popleft()
            for r in batch:
                self._latencies.append(t_done - r.t_enqueue)
            if degraded:
                self._degraded_batches += 1
            if err is not None:
                self._errors += len(batch)

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        """Gateway counters for `/v1/stats`."""
        with self._cv:
            lat = sorted(self._latencies)
            now = time.monotonic()
            recent_rows = sum(r for t, r in self._recent
                              if now - t <= RATE_WINDOW_S)
            window = min(max(now - self._t_start, 1e-9), RATE_WINDOW_S)
            out = {
                "queue_depth": self._pending,
                "max_pending": self.max_pending,
                "max_delay_ms": self.max_delay_s * 1000.0,
                "target_rows": self.target_rows,
                "requests": self._reqs_done,
                "rows": self._rows_done,
                "rows_per_sec": round(recent_rows / window, 2),
                "batch_rows_hist": {str(k): v for k, v in
                                    sorted(self._batch_hist.items())},
                "latency_ms": {
                    "p50": round(_percentile(lat, 0.50) * 1e3, 3),
                    "p95": round(_percentile(lat, 0.95) * 1e3, 3),
                    "p99": round(_percentile(lat, 0.99) * 1e3, 3),
                },
                "deadline_misses": self._deadline_misses,
                "errors": self._errors,
                "degraded_batches": self._degraded_batches,
            }
        breaker = self.breaker.stats()
        out["degraded"] = breaker["state"] != CircuitBreaker.CLOSED
        out["breaker"] = breaker
        return out

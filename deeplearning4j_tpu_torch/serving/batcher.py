"""Dynamic micro-batching for predicts, continuous batching for generation.

Counterpart of `MicroBatcher`, `GenerationStream` and `ContinuousBatcher`
in `deeplearning4j_tpu/serving/batcher.py`. Predict requests land on a
per-(feature shape, dtype) FIFO from any thread, and one dispatcher thread
drains them into a single `net.output()` call.

Flush policy: the dispatcher takes the queue that holds the oldest queued
request (FIFO across shapes), and flushes it once its rows reach the target
batch (`max_batch_rows`, else `DEFAULT_TARGET_ROWS`) or that request has
waited `max_delay_ms`. Requests past their `deadline_ms` are answered
`DeadlineExceeded` before they are batched. "interactive" requests are
queued ahead of "batch" ones, so a queue's head is not always its oldest
request. The queue is bounded by `max_pending`; beyond it `predict()` raises
`ServerOverloaded`. `stats()` has the JAX package's keys, with each priority
class's queue depth, requests, latency percentiles and latency histogram
(`LATENCY_BUCKETS_S`), the infer cache's books (`fresh_compiles` is its
misses: captures) and the JAX package's `precision` block: the active
serve-precision policy, the rows served under each policy (recorded per
batch when it ran) and the network's `serve_precision_report`.

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

`ContinuousBatcher` runs autoregressive generation over a fixed table of
decode slots (Orca-style continuous batching): each table step is one
decode call over every slot (on CUDA, one graph replay), a stream that
finishes frees its slot, and the next queued stream is admitted into it by
a B = 1 prefill on the very next step. Its options are the JAX package's:
several steps a dispatch, pipelined (`steps_per_dispatch`), a paged KV pool
(`page_size`, `n_pages`), the prefix cache (`prefix_cache`,
`prefix_match`) and speculative decoding with a recurrent draft model
(`draft_net`, `spec_k`), each off by default (`DEFAULT_SLOTS`,
`DEFAULT_PAGE_SIZE`, `DEFAULT_STEPS_PER_DISPATCH`: the JAX package's
registry defaults).
"""

from __future__ import annotations

import hashlib
import io
import queue
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.optimize import tunables
from deeplearning4j_tpu_torch.reliability import (CircuitBreaker,
                                                  DeadlineExceeded, faults)

#: coalescing target in rows when the caller sets no `max_batch_rows` and
#: no tuned table names one: the registry default of "batcher.target_rows"
#: (`optimize/tunables.py`)
DEFAULT_TARGET_ROWS = tunables.default("batcher.target_rows")

#: flush deadline when the caller sets no `max_delay_ms` and no tuned table
#: names one: the registry default of "batcher.max_delay_ms"
DEFAULT_MAX_DELAY_MS = tunables.default("batcher.max_delay_ms")

#: rows/s is reported over this trailing window (seconds)
RATE_WINDOW_S = 10.0

#: request priority classes, highest first
PRIORITIES = ("interactive", "batch")

#: decode slots when the caller gives none and no tuned table names them:
#: the registry default of "decode.slots"
DEFAULT_SLOTS = tunables.default("decode.slots")

#: histogram bounds (seconds) of a predict's latency by priority class and of
#: time to first token, the JAX package's `le` upper bounds (+Inf implied)
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: histogram bounds of decode steps a dispatch (K of a block), the JAX
#: package's
DECODE_BLOCK_STEPS_BOUNDS = (1, 2, 4, 8, 16)

#: histogram bounds of the tokens a slot accepts in a speculative round (at
#: least 1), the JAX package's
ACCEPTED_TOKENS_BOUNDS = (1, 2, 3, 4, 6, 8, 12, 16)


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
        # None -> the tunable's effective value (a tuned table's if one is
        # installed, else the registry default)
        if max_delay_ms is None:
            max_delay_ms = tunables.resolve("batcher.max_delay_ms")
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.max_pending = int(max_pending)
        self.target_rows = int(max_batch_rows
                               or tunables.resolve("batcher.target_rows"))
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
        # (t_done, rows, policy): the policy of each batch as it ran, so
        # that rows per policy stay right when the policy changes
        self._recent: Deque[Tuple[float, int, str]] = deque()
        self._rows_by_policy: Dict[str, int] = {}
        self._deadline_misses = 0
        self._errors = 0
        self._degraded_batches = 0
        # per priority class: queued requests, answered requests (errors
        # and deadline misses included), latencies, and a latency histogram
        # of those answered without an error
        self._pending_by = {p: 0 for p in PRIORITIES}
        self._reqs_by = {p: 0 for p in PRIORITIES}
        self._lat_by = {p: deque(maxlen=4096) for p in PRIORITIES}
        self._lat_hist = {p: _new_hist(LATENCY_BUCKETS_S)
                          for p in PRIORITIES}

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
                self._reqs_by[priority] += 1
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
            self._pending_by[priority] += 1
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
        """(key, t_enqueue) of the queue holding the oldest queued request
        (FIFO across shapes), or None. A queue's head is not its oldest
        request once an interactive request went ahead of batch ones, so
        every request counts (the JAX package keeps an arrival heap).
        Caller holds `_cv`."""
        oldest = [(min(r.t_enqueue for r in q), key)
                  for key, q in self._queues.items() if q]
        if not oldest:
            return None
        t, key = min(oldest, key=lambda o: o[0])
        return key, t

    def _evict_expired_locked(self, now: float) -> None:
        """Answer every queued request past its deadline with
        `DeadlineExceeded` before it is batched. Caller holds `_cv`."""
        for q in self._queues.values():
            expired = [r for r in q
                       if r.deadline is not None and r.deadline <= now]
            for r in expired:
                q.remove(r)
                self._pending -= 1
                self._pending_by[r.priority] -= 1
                self._reqs_by[r.priority] += 1
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
                oldest = self._oldest_key()
                if oldest is None:
                    if self._stop:
                        return
                    self._cv.wait()
                    continue
                key, t_oldest = oldest
                q = self._queues[key]
                queued_rows = sum(r.rows for r in q)
                flush_at = t_oldest + self.max_delay_s
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
                for r in batch:
                    self._pending_by[r.priority] -= 1
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
        policy = self.net.infer_cache.policy
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
            self._rows_by_policy[policy] = (
                self._rows_by_policy.get(policy, 0) + rows)
            self._recent.append((t_done, rows, policy))
            while self._recent and t_done - self._recent[0][0] > RATE_WINDOW_S:
                self._recent.popleft()
            for r in batch:
                lat = t_done - r.t_enqueue
                self._latencies.append(lat)
                self._lat_by[r.priority].append(lat)
                self._reqs_by[r.priority] += 1
                if err is None:
                    _hist_add(self._lat_hist[r.priority], LATENCY_BUCKETS_S,
                              lat)
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
            recent_rows, recent_by_policy = 0, {}
            for t, r, pol in self._recent:
                if now - t <= RATE_WINDOW_S:
                    recent_rows += r
                    recent_by_policy[pol] = recent_by_policy.get(pol, 0) + r
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
                "priorities": {p: self._priority_stats(p)
                               for p in PRIORITIES},
                # the active policy, rows per policy and the accuracy
                # delta measured when it was set (serving has no labels)
                "precision": {
                    "policy": self.net.infer_cache.policy,
                    "rows_by_policy": dict(self._rows_by_policy),
                    "rows_per_sec_by_policy": {
                        p: round(r / window, 2)
                        for p, r in sorted(recent_by_policy.items())},
                    "report": getattr(self.net, "serve_precision_report",
                                      {"policy": "f32"})},
                # autotuning state: tuned-table presence + fresh_tunes (a
                # process that inherited its table from disk shows 0)
                "tuning": tunables.status(),
            }
        cache = self.net.infer_cache.stats
        out["fresh_compiles"] = cache.misses
        out["cache"] = cache.as_dict()
        breaker = self.breaker.stats()
        out["degraded"] = breaker["state"] != CircuitBreaker.CLOSED
        out["breaker"] = breaker
        return out

    def _priority_stats(self, p: str) -> dict:
        """One priority class's block of `stats()`. Caller holds `_cv`."""
        lat = sorted(self._lat_by[p])
        return {"queue_depth": self._pending_by[p],
                "requests": self._reqs_by[p],
                "latency_ms": {"p50": round(_percentile(lat, 0.50) * 1e3, 3),
                               "p99": round(_percentile(lat, 0.99) * 1e3, 3)},
                "latency_hist_s": _hist_out(self._lat_hist[p],
                                            LATENCY_BUCKETS_S)}


# -- continuous batching for autoregressive generation ----------------------

#: decode steps a dispatch and KV page size when the caller gives none and
#: no tuned table names them: the registry defaults of
#: "decode.steps_per_dispatch" and "decode.page_size"
DEFAULT_STEPS_PER_DISPATCH = tunables.default("decode.steps_per_dispatch")
DEFAULT_PAGE_SIZE = tunables.default("decode.page_size")

#: prefix-cache entries kept in memory by a batcher (LRU), the JAX package's
PREFIX_CACHE_ENTRIES = 32

#: the block sizes the batcher's adaptive K may dispatch under a ceiling of
#: `k_max` (`optimize/tunables.decode_k_ladder`); `warmup_generate` captures
#: exactly this ladder
decode_k_ladder = tunables.decode_k_ladder


def decode_geometry(n_slots=None, max_seq: int = 64, page_size=None,
                    n_pages: int = 0, steps_per_dispatch=None,
                    draft_net=None, spec_k: int = 0) -> dict:
    """The decode table a `ContinuousBatcher` runs and `warmup_generate`
    captures, from the caller's options and the defaults: slots, page size,
    pages a slot and usable pages (0 and 0 for the dense table; the pool
    holds one more, the scratch page 0), the largest K a dispatch and the
    speculative chunk (0 without a draft, as in the JAX package). Raises
    the JAX package's ValueErrors for a K below 1 and for a draft it cannot
    speculate with: `spec_k` < 2, a draft with attention (its rejected
    tokens roll back to retained carries), a `max_seq` past the draft's
    positional table, `steps_per_dispatch` > 1."""
    from deeplearning4j_tpu_torch.nn import decode as decode_mod
    from deeplearning4j_tpu_torch.nn.conf import LayerType

    # None -> tunable-governed geometry ("decode.slots", "decode.page_size",
    # "decode.steps_per_dispatch"); explicit arguments always win, so that
    # warmup and the batcher stay geometry-identical when the caller pins
    slots = int(tunables.resolve("decode.slots") if n_slots is None
                else n_slots)
    ps = int(tunables.resolve("decode.page_size") if page_size is None
             else page_size)
    explicit_k = steps_per_dispatch is not None
    k_max = int(tunables.resolve("decode.steps_per_dispatch")
                if steps_per_dispatch is None else steps_per_dispatch)
    if k_max < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k_max}")
    spec_k = int(spec_k) if draft_net is not None else 0
    if draft_net is not None:
        if spec_k < 2:
            raise ValueError(
                "speculative decoding needs spec_k >= 2 (current token + at "
                "least one draft position per verify)")
        d_types = decode_mod.check_generative(draft_net.conf)
        if LayerType.ATTENTION in d_types:
            raise ValueError(
                "the draft model must be recurrent-only: rejected draft "
                "tokens roll its carries back to a retained copy, which K/V "
                "tables are too large to retain per position")
        dbound = decode_mod.positional_bound(draft_net.conf)
        if dbound and int(max_seq) > dbound:
            raise ValueError(
                f"max_seq={max_seq} exceeds the DRAFT model's positional "
                f"table (max_seq_len={dbound})")
        if k_max > 1 and not explicit_k:
            k_max = 1  # a tuned table's K > 1 silently yields to spec
        if k_max > 1:
            raise ValueError(
                "speculative decoding is pinned to steps_per_dispatch=1: "
                "draft/verify rounds already advance multiple positions per "
                "dispatch and roll draft carries back per round; drop "
                "spec_k or steps_per_dispatch")
    per_slot = -(-int(max_seq) // ps) if ps > 0 else 0
    return {"slots": slots, "page_size": max(ps, 0),
            "pages_per_slot": per_slot,
            "n_pages": (int(n_pages) or slots * per_slot) if ps > 0 else 0,
            "k_max": k_max, "spec_k": spec_k}


class PagesExhausted(RuntimeError):
    """The KV page pool has no free page for the request. At admission the
    stream waits in the queue (pages free as streams finish); past
    admission (an overcommitted pool) the one stream that could not grow is
    preempted, never the table."""


class _PagePool:
    """The host's free list over the physical K/V page pool. Page 0 is the
    scratch page: every released slot's table row points there, so what
    inactive rows write lands behind the mask and in no one's context.
    Usable pages are 1..n_pages; `alloc` passes the `decode.page_alloc`
    fault point (an armed raise fails the one stream being grown) and
    raises `PagesExhausted` past the free list."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        # pop() hands out ascending ids: 1, 2, ...
        self._free = list(range(self.n_pages, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int, **ctx) -> List[int]:
        faults.fire("decode.page_alloc", requested=n,
                    free=len(self._free), **ctx)
        if n > len(self._free):
            raise PagesExhausted(
                f"{n} KV pages requested, {len(self._free)} free "
                f"(pool={self.n_pages})")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if int(p):
                self._free.append(int(p))


def _host_sample(logp, key, temperature: float):
    """One row of the programs' sampler on the host (`nd/random.py` on CPU
    tensors): split the stream's key once, argmax at temperature <= 0, else
    `categorical(sub, logp / temperature)`. So one cached prefill logp
    serves streams of any key and temperature. Returns (token, the advanced
    key as uint32 [2]). The keys are the device sampler's bit for bit; a
    draw can differ only where the Gumbel's `log` rounds otherwise on the
    card and two candidates tie to that last place."""
    import torch

    from deeplearning4j_tpu_torch.nd import random as nd_random

    ks = nd_random.split(nd_random.key_array(key))
    new_key, sub = ks[0], ks[1]
    logp = torch.as_tensor(np.asarray(logp, np.float32))
    if temperature > 0:
        tok = int(nd_random.categorical(
            sub, logp / torch.tensor(np.float32(temperature))))
    else:
        tok = int(torch.argmax(logp))
    return tok, new_key.numpy().astype(np.uint32)


def _on_device(a: np.ndarray, device):
    """A host array on `device`, from a pinned copy without blocking when
    the device is a card (the caller may rewrite `a` at once)."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


class _BlockRead:
    """One block's (toks, last tok, keys) on their way to the host: one
    device concatenation and one copy into pinned memory, both enqueued
    without blocking, and an event after them; `wait` blocks on that event
    only. So the host can dispatch the next block before it reads this
    one."""

    def __init__(self, toks, tok, keys):
        import torch

        self.k, self.b = (int(d) for d in toks.shape)
        flat = torch.cat([toks.long().reshape(-1), tok.long(),
                          keys.reshape(-1)])
        self._event = None
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
            self._flat = host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._flat = flat

    def wait(self):
        """(toks [k, B] int32, tok [B] int32, keys [B, 2] uint32)."""
        if self._event is not None:
            self._event.synchronize()
        a = self._flat.numpy()
        kb = self.k * self.b
        return (a[:kb].reshape(self.k, self.b).astype(np.int32),
                a[kb:kb + self.b].astype(np.int32),
                a[kb + self.b:].reshape(self.b, 2).astype(np.uint32))


class GenerationStream:
    """One generation request in flight: its prompt, its sampling knobs and
    the queue of tokens the HTTP handler (or any caller thread) drains while
    the decode loop produces them.

    `tokens()` yields ints as they come and raises the stream's stored error
    after every token that preceded it, when generation failed midway."""

    def __init__(self, prompt, max_new_tokens: int, temperature: float,
                 rng_seed: int):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new_tokens)
        self.temperature = float(temperature)
        # the stream's key (`jax.random.PRNGKey(rng_seed)`), split once a
        # token on the device
        self.key = np.asarray([0, int(rng_seed) & 0xFFFFFFFF], np.uint32)
        self.error: Optional[BaseException] = None
        self.tokens_emitted = 0
        #: tokens to swallow when the stream is admitted again after a
        #: page-pool preemption (the recompute derives them anew)
        self._replay = 0
        self._counted_admit = False
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self._q: "queue.Queue" = queue.Queue()

    # decode-loop side ------------------------------------------------------
    def _emit(self, tok: int, now: float) -> None:
        if self.t_first is None:
            self.t_first = now
        self.tokens_emitted += 1
        self._q.put(int(tok))

    def _deliver(self, tok: int, now: float) -> bool:
        """Emit `tok`, unless it replays a token delivered before a
        page-pool preemption: decoding is deterministic given the prompt and
        the key, so the recompute derives the prefix the consumer already
        has, and those tokens are swallowed. True when emitted."""
        if self._replay > 0:
            self._replay -= 1
            return False
        self._emit(tok, now)
        return True

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self.t_done = time.monotonic()
        self._q.put(None)

    # consumer side ---------------------------------------------------------
    def tokens(self, timeout: Optional[float] = None):
        """Yield the generated token ids until the stream completes; raises
        the stored error, or TimeoutError when no token comes within
        `timeout` seconds."""
        while True:
            try:
                t = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no token within {timeout}s (stream has "
                    f"{self.tokens_emitted} so far)") from None
            if t is None:
                if self.error is not None:
                    raise self.error
                return
            yield t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit


def _hist_add(h: dict, bounds, v: float) -> None:
    h["sum"] += v
    h["count"] += 1
    for i, bound in enumerate(bounds):
        if v <= bound:
            h["counts"][i] += 1
            return
    h["inf"] += 1


def _new_hist(bounds) -> dict:
    return {"counts": [0] * len(bounds), "inf": 0, "sum": 0.0, "count": 0}


def _hist_out(h: dict, bounds) -> dict:
    return {"bounds": list(bounds), "counts": list(h["counts"]),
            "inf": h["inf"], "sum": h["sum"], "count": h["count"]}


class ContinuousBatcher:
    """A fixed-width table of decode slots with admission every step
    (continuous batching).

    Every table step is ONE decode call over all `n_slots` rows; a stream
    that finishes frees its slot, and the next queued stream is admitted
    into it (a B = 1 prefill that also draws its first token, then its row
    copied into the table) before the next step, instead of waiting for its
    longest neighbour. `continuous=False` admits only when EVERY slot is
    free, so each wave waits for its longest stream.

    Rows are independent (each slot has its own K/V rows, LSTM carries and
    key), so packing never changes a stream's tokens. The table (or page
    pool) and the admission row are the infer cache's own states
    (`decode_state`), the ones `MultiLayerNetwork.warmup_generate` captures
    on. Three options, off by default, each token-identical to the plain
    path, as in the JAX package:

    steps_per_dispatch > 1  K steps a dispatch (`InferCache.decode_multi`):
                    while the slot set is stable the loop dispatches block
                    N + 1 from block N's device outputs before it reads
                    block N back, so the host's work of a block overlaps the
                    card's. K ramps 1, 2, 4, ... up to the ceiling, and
                    pins to 1 while admissions wait or prompt tokens are
                    fed; any admission, release or preemption restarts the
                    ramp.
    page_size > 0   paged KV: a shared pool of `n_pages` pages and a page
                    table a slot; memory scales with live tokens, and a pool
                    smaller than slots x pages a slot overcommits: an
                    admission that finds no page waits in the queue, and a
                    stream that cannot grow is preempted, queued first and
                    recomputed, its delivered tokens swallowed.
    prefix_cache    the prefill by prompt digest: a repeated prompt copies
                    the cached row (a host copy) and draws its first token
                    on the host from the cached logp with its own key;
                    `prefix_match="longest"` also reuses the longest cached
                    strict prefix and feeds the rest of the prompt through
                    the decode table. With the network's store attached
                    (`set_compile_cache`) each entry is written through to
                    it, and an exact miss in memory is looked up there, so
                    another process's batcher serves the prompt from the
                    disk entry with the same tokens; a corrupt entry is a
                    counted miss and a cold prefill. Under a model axis
                    each rank holds its own heads' K/V columns, and the
                    disk store is not used.
    draft_net, spec_k  speculative decoding: a recurrent-only draft network
                    proposes spec_k - 1 tokens a slot (greedily, from its own
                    slot table kept in lockstep with the target's), and one
                    `InferCache.verify` advances every slot spec_k positions,
                    chain-samples spec_k tokens with the slot's own keys and
                    rolls the target's carries back in the program; the slot
                    emits the samples up to the first disagreement (at least
                    one), and the draft's carries roll back to a copy kept
                    after each of its steps. The emitted tokens are the
                    target's own samples, so streams are the one-step
                    path's at any temperature. K pins to 1.

    A fault at the `decode.step` point ends that slot's stream only (inside
    a block it fires for every scheduled position), one at
    `generate.admit` the admitted stream only, one at `decode.page_alloc`
    the stream being grown, and one at `generate.prefix_lookup` gives a
    counted miss and a cold prefill. A failed decode call (a capture that
    raises included, and a draft step's or a verify's) ends every stream it
    was decoding, and nothing falls back to another path."""

    def __init__(self, net, n_slots: Optional[int] = None, max_seq: int = 64,
                 prompt_buckets: Tuple[int, ...] = (8,),
                 max_pending: int = 64, continuous: bool = True,
                 auto_start: bool = True, page_size: Optional[int] = None,
                 n_pages: int = 0, prefix_cache: bool = False,
                 prefix_match: str = "exact", draft_net=None,
                 spec_k: int = 0,
                 steps_per_dispatch: Optional[int] = None):
        from deeplearning4j_tpu_torch.nn import decode as decode_mod

        geo = decode_geometry(n_slots, max_seq, page_size, n_pages,
                              steps_per_dispatch, draft_net, spec_k)
        self.net = net
        self.n_slots = geo["slots"]
        self.max_seq = int(max_seq)
        self.prompt_buckets = tuple(sorted(
            int(b) for b in prompt_buckets if int(b) <= self.max_seq))
        self.max_pending = int(max_pending)
        self.continuous = bool(continuous)
        self._auto_start = auto_start
        self._layer_types = decode_mod.check_generative(net.conf)
        # a learned positional table is gathered at P[pos] with no bound
        # check on the device, so the table edge (`submit` clamps max_new
        # to max_seq - n) must lie within it
        bound = decode_mod.positional_bound(net.conf)
        if bound and self.max_seq > bound:
            raise ValueError(
                f"max_seq={self.max_seq} exceeds the learned positional "
                f"table (max_seq_len={bound}); decoding past it would read "
                f"P[pos] out of range")
        # -- speculative decoding (decode_geometry checked the draft) --------
        self.draft_net = draft_net
        self.spec_k = geo["spec_k"]
        if draft_net is not None:
            # tokens pass between the two nets on the device, unchecked
            vocab = [(c.conf(0).n_in, c.conf(c.n_layers - 1).n_out)
                     for c in (net.conf, draft_net.conf)]
            if vocab[0] != vocab[1]:
                raise ValueError(
                    f"the draft's vocabulary (in, out) {vocab[1]} is not "
                    f"the target's {vocab[0]}")
        self._draft_state = None           # the draft's [n_slots] rows
        self._draft_row = None             # its B = 1 admission row
        self._draft_zeros = None           # its keys and temperatures
        self._spec_rounds = 0
        self._accept_hist = _new_hist(ACCEPTED_TOKENS_BOUNDS)
        # -- paged KV (page 0 is the scratch page) --------------------------
        self.page_size = geo["page_size"]
        self.paged = self.page_size > 0
        self.pages_per_slot = geo["pages_per_slot"]
        self.n_pages = geo["n_pages"]
        self._pool: Optional[_PagePool] = None
        self._page_table = None
        if self.paged:
            if self.n_pages < self.pages_per_slot:
                raise ValueError(
                    f"n_pages={self.n_pages} cannot hold even one "
                    f"max_seq={self.max_seq} stream "
                    f"({self.pages_per_slot} pages of {self.page_size})")
            self._pool = _PagePool(self.n_pages)
            self._page_table = np.zeros(
                (self.n_slots, self.pages_per_slot), np.int32)
        # -- prefix cache ----------------------------------------------------
        self.prefix_cache_enabled = bool(prefix_cache)
        if prefix_match not in ("exact", "longest"):
            raise ValueError(f"prefix_match must be 'exact' or 'longest', "
                             f"got {prefix_match!r}")
        self.prefix_match = prefix_match
        self._prefix_lru: "OrderedDict[str, tuple]" = OrderedDict()
        self._forget = None
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_disk_hits = 0
        # -- K steps a dispatch ----------------------------------------------
        self.k_max = geo["k_max"]
        self._k_ladder = decode_k_ladder(self.k_max)
        # the adaptive K (decode-loop thread only): doubles a stable block
        # up the ladder, back to 1 on an admission, release or preemption
        self._ramp = 1
        self._cv = threading.Condition()
        self._pending: Deque[GenerationStream] = deque()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # -- slot table (decode-loop thread only) --------------------------
        self._state = None                 # [n_slots] rows (or the pool)
        self._row = None                   # the B = 1 admission row
        self._slots: List[Optional[GenerationStream]] = [None] * self.n_slots
        self._tok = np.zeros((self.n_slots,), np.int32)
        self._pos = np.zeros((self.n_slots,), np.int32)
        self._keys = np.zeros((self.n_slots, 2), np.uint32)
        self._temps = np.zeros((self.n_slots,), np.float32)
        # prompt tokens still to feed through a slot admitted on a longest
        # prefix match (empty with the option off)
        self._feed: List[List[int]] = [[] for _ in range(self.n_slots)]
        # -- stats (under _cv's lock) --------------------------------------
        self._t_start = time.monotonic()
        self._tokens_total = 0
        self._admitted = 0
        self._completed = 0
        self._failed = 0
        self._preempted = 0
        self._active = 0
        self._recent_tokens: Deque[Tuple[float, int]] = deque()
        self._ttfts: Deque[float] = deque(maxlen=4096)
        self._ttft_hist = _new_hist(LATENCY_BUCKETS_S)
        # host share of each dispatch: wall = dispatch to read-back, host =
        # wall less the time spent waiting for the device's answer
        self._host_s = 0.0
        self._wall_s = 0.0
        self._blk_hist = _new_hist(DECODE_BLOCK_STEPS_BOUNDS)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        import torch

        with self._cv:
            if self._thread is not None:
                return self
            self._stop = False
            if self._state is None:
                ic, net = self.net.infer_cache, self.net
                if self.paged:
                    self._state = ic.claim_decode_state(
                        net.conf, self.n_slots, self.max_seq, net.device,
                        "pool", pages=(self.n_pages + 1, self.page_size))
                else:
                    self._state = ic.claim_decode_state(
                        net.conf, self.n_slots, self.max_seq, net.device,
                        "table")
                self._row = ic.claim_decode_state(
                    net.conf, 1, self.max_seq, net.device, "row")
                ic.reset_state(self._state)
                if self.draft_net is not None:
                    # roles of their own: a draft net may also serve as a
                    # target elsewhere
                    dn = self.draft_net
                    self._draft_state = dn.infer_cache.claim_decode_state(
                        dn.conf, self.n_slots, self.max_seq, dn.device,
                        "draft")
                    self._draft_row = dn.infer_cache.claim_decode_state(
                        dn.conf, 1, self.max_seq, dn.device, "draft-row")
                    ic.reset_state(self._draft_state)
                    self._draft_zeros = (
                        torch.zeros((self.n_slots, 2), dtype=torch.int64,
                                    device=dn.device),
                        torch.zeros((self.n_slots,), device=dn.device))
            self._thread = threading.Thread(
                target=self._decode_loop, name="dl4j-torch-decode",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the decode loop; queued and running streams are decoded to
        the end first."""
        with self._cv:
            self._stop = True
            thread, self._thread = self._thread, None
            self._cv.notify_all()
        if thread is not None:
            thread.join(timeout=timeout)
            if not thread.is_alive() and self._state is not None:
                ic = self.net.infer_cache
                ic.release_state(self._state)
                ic.release_state(self._row)
                self._state = self._row = None
                if self._draft_state is not None:
                    dic = self.draft_net.infer_cache
                    dic.release_state(self._draft_state)
                    dic.release_state(self._draft_row)
                    self._draft_state = self._draft_row = None

    # -- request side (any thread) ------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0,
               rng_seed: int = 0) -> GenerationStream:
        """Queue a generation request and return its `GenerationStream` at
        once (tokens arrive on `stream.tokens()`); greedy at
        `temperature <= 0`. Raises ServerOverloaded past `max_pending`
        queued streams, and ValueError for a prompt the table cannot hold
        or token ids outside the vocabulary."""
        stream = GenerationStream(prompt, max_new_tokens, temperature,
                                  rng_seed)
        n = int(stream.prompt.shape[0])
        if n < 1:
            raise ValueError("prompt must hold at least one token id")
        if n >= self.max_seq:
            raise ValueError(
                f"prompt of {n} tokens leaves no room to generate in a "
                f"max_seq={self.max_seq} decode table")
        if stream.max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.net.check_input(stream.prompt[None])
        # the table's edge bounds the stream
        stream.max_new = min(stream.max_new, self.max_seq - n)
        with self._cv:
            if self._stop and self._thread is None:
                raise ServerOverloaded("generation batcher is stopped")
            if len(self._pending) >= self.max_pending:
                raise ServerOverloaded(
                    f"{len(self._pending)} generation streams already "
                    f"pending (max_pending={self.max_pending})")
            self._pending.append(stream)
            self._cv.notify_all()
        if self._thread is None and self._auto_start:
            self.start()
        return stream

    def generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, rng_seed: int = 0,
                 timeout: Optional[float] = 60.0) -> List[int]:
        """Submit, and drain the whole stream."""
        stream = self.submit(prompt, max_new_tokens, temperature, rng_seed)
        return list(stream.tokens(timeout=timeout))

    # -- admission (decode-loop thread) --------------------------------------
    def _prompt_bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return n  # longer than every bucket: its own (a new capture)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _admit_one(self, slot: int, stream: GenerationStream) -> None:
        """Prefill `stream` into `slot`: one B = 1 prefill fills the zeroed
        admission row and draws the stream's first token (its time to first
        token), then the row is copied into the slot (into freshly
        allocated pages when paged).

        A prefix-cache hit skips the prefill: the cached row is copied in,
        and either (exact) the first token is drawn on the host from the
        cached logp with the stream's own key, or (longest) the unmatched
        prompt tokens are queued to feed through the decode table. Either
        way the tokens are a cold prefill's."""
        ic, net = self.net.infer_cache, self.net
        faults.fire("generate.admit", slot=slot,
                    prompt_tokens=int(stream.prompt.shape[0]))
        n = int(stream.prompt.shape[0])
        hit = (self._prefix_lookup(stream.prompt)
               if self.prefix_cache_enabled else None)
        m = n if hit is None else hit[0]
        pages = None
        if self.paged:
            # before any device work: a dry pool queues the stream without
            # a wasted prefill
            pages = self._pool.alloc(-(-m // self.page_size), slot=slot)
        try:
            tok0, key1, row = self._first_token(stream, hit)
            self._scatter_row(slot, row, pages)
            if self.draft_net is not None:
                # the draft consumes the m tokens the target's row has, so
                # that feed steps advance both in lockstep
                self._draft_admit(slot, stream.prompt[:m])
        except BaseException:
            if pages:
                self._pool.free(pages)
            raise
        self._slots[slot] = stream
        self._temps[slot] = stream.temperature
        self._ramp = 1
        now = time.monotonic()
        delivered = False
        if tok0 is not None:
            self._tok[slot] = tok0
            self._pos[slot] = n
            self._keys[slot] = key1
            delivered = stream._deliver(tok0, now)
        else:
            # longest match: the next steps consume the unmatched prompt
            # tokens, and the key stays unsplit until the step that
            # consumes the last of them draws the first real token
            self._tok[slot] = int(stream.prompt[m])
            self._pos[slot] = m
            self._keys[slot] = stream.key
            self._feed[slot] = [int(x) for x in stream.prompt[m + 1:]]
        with self._cv:
            if not stream._counted_admit:
                stream._counted_admit = True
                self._admitted += 1
            self._active += 1
            if delivered:
                self._tokens_total += 1
                self._recent_tokens.append((now, 1))
                self._record_ttft_locked(stream)
        if tok0 is not None and stream.tokens_emitted >= stream.max_new:
            self._release_slot(slot, stream)

    def _first_token(self, stream: GenerationStream, hit):
        """(first token, its advanced key, the row state) of an admission:
        a prefill of the zeroed admission row (`prefill_logp` and a host
        draw with the prefix cache, stored; else `prefill`, which draws on
        the device), or a prefix hit's row (the token None on a longest
        match)."""
        if hit is not None:
            if hit[1] is None:
                return None, None, hit[3]
            return (*_host_sample(hit[1], stream.key, stream.temperature),
                    hit[3])
        ic, net = self.net.infer_cache, self.net
        n = int(stream.prompt.shape[0])
        prompt = np.zeros((1, self._prompt_bucket(n)), np.int32)
        prompt[0, :n] = stream.prompt
        length = np.asarray([n], np.int32)
        ic.reset_state(self._row)
        if self.prefix_cache_enabled:
            logp, row = ic.prefill_logp(net.conf, net.params, self._row,
                                        prompt, length)
            logp = logp[0].cpu().numpy()
            self._prefix_store(stream.prompt, logp, row)
            return (*_host_sample(logp, stream.key, stream.temperature),
                    row)
        t0, keys1, row = ic.prefill(
            net.conf, net.params, self._row, prompt, length,
            stream.key[None], np.asarray([stream.temperature], np.float32))
        return (int(t0[0]), keys1[0].cpu().numpy().astype(np.uint32), row)

    def _record_ttft_locked(self, stream: GenerationStream) -> None:
        """Books of a stream's first token (the caller holds `_cv`)."""
        self._ttfts.append(stream.ttft_s)
        _hist_add(self._ttft_hist, LATENCY_BUCKETS_S, stream.ttft_s)

    def _scatter_row(self, slot: int, row, pages: Optional[List[int]]):
        """Copy a B = 1 row state (the admission row on the device, or a
        prefix entry's kept row, by its handle) into the table's row
        `slot` (`InferCache.scatter_row`, on every rank under a model
        axis); paged, the row's dense K/V go into the freshly allocated
        pages."""
        ic = self.net.infer_cache
        pages = None if not self.paged else [int(p) for p in pages]
        if isinstance(row, str):
            ic.scatter_row(self._state, slot, pages=pages, kept=row)
        else:
            ic.scatter_row(self._state, slot, row, pages=pages)
        if self.paged:
            self._page_table[slot, :] = 0
            self._page_table[slot, :len(pages)] = pages

    def _draft_admit(self, slot: int, prompt: np.ndarray) -> None:
        """Prefill the draft's admission row over `prompt` (the tokens the
        target's row has consumed) and copy it into the draft's row
        `slot`. The draft decodes greedily with a zero key: its proposals
        only gate acceptance, they are never emitted."""
        import torch

        dn = self.draft_net
        dic = dn.infer_cache
        m = int(prompt.shape[0])
        pb = np.zeros((1, self._prompt_bucket(m)), np.int32)
        pb[0, :m] = prompt
        dic.reset_state(self._draft_row)
        _, _, row = dic.prefill(dn.conf, dn.params, self._draft_row, pb,
                                np.asarray([m], np.int32),
                                np.zeros((1, 2), np.uint32),
                                np.zeros((1,), np.float32))
        with torch.no_grad():
            for lay, r in zip(self._draft_state, row):
                for name, tbl in lay.items():
                    tbl[slot].copy_(r[name][0], non_blocking=True)

    # -- prefix cache -------------------------------------------------------
    def _prefix_digest(self, prompt: np.ndarray) -> str:
        """The key of a prompt's prefill: its tokens, the conf fingerprint,
        max_seq (the row's shape) and the serving policy, the dimensions
        that key the prefill program itself; a plan with a model axis
        folds its decode tag in (its rows are laid out by rank), as the
        JAX package's does. One-rank and 1-D digests stay as they were."""
        ic = self.net.infer_cache
        h = hashlib.sha256()
        h.update(ic._fingerprint(self.net.conf).encode())
        h.update(repr((self.max_seq, ic.policy)).encode())
        tag = ic._decode_tag()
        if tag != ic.SINGLE:
            h.update(repr(tag).encode())
        h.update(np.ascontiguousarray(prompt, np.int32).tobytes())
        return h.hexdigest()

    def _prefix_store(self, prompt: np.ndarray, logp: np.ndarray,
                      row) -> None:
        """Keep a cold prefill (`_prefix_keep`) and write it through to the
        network's store, where there is one (`_prefix_disk_write`)."""
        digest = self._prefix_digest(prompt)
        entry = self._prefix_keep(digest, prompt, logp, row)
        self._prefix_disk_write(digest, entry)

    def _prefix_disk_store(self):
        """The store prefix entries go through: the network's, off a model
        axis (where each rank holds its own K/V columns)."""
        ic = self.net.infer_cache
        if ic.persist is None or ic.plan.has_model_axis:
            return None
        return ic.persist

    def _prefix_disk_key(self, digest: str) -> tuple:
        """The store key of a prefix entry: its digest and the digest of
        the weights served (`InferCache.weights_digest`), so that an entry
        another checkpoint of the same conf wrote is a miss."""
        return ("prefix", self.net.infer_cache.weights_digest(
            self.net.params), digest)

    def _prefix_disk_write(self, digest: str, entry) -> None:
        """Write an entry to the store as one npz blob: the prompt, the
        logp and each layer's row tensors, named "L<layer>_<name>|<dtype>"
        (a bfloat16 tensor as its 16-bit pattern, so that it comes back
        bit for bit). Best effort: a failed write changes nothing."""
        store = self._prefix_disk_store()
        if store is None:
            return
        import torch

        try:
            arrs = {"prompt": entry[0],
                    "logp": np.asarray(entry[1], np.float32),
                    "n_layers": np.asarray(len(entry[2]), np.int64)}
            for i, lay in enumerate(entry[2]):
                for name, t in lay.items():
                    dt = str(t.dtype).replace("torch.", "")
                    if t.dtype == torch.bfloat16:
                        t = t.view(torch.int16)
                    arrs[f"L{i}_{name}|{dt}"] = t.cpu().numpy()
            buf = io.BytesIO()
            np.savez(buf, **arrs)
            store.store_bytes(self._prefix_disk_key(digest),
                              buf.getvalue())
        except Exception:  # noqa: BLE001 — the disk is best effort
            pass

    def _prefix_disk_load(self, digest: str):
        """The store's entry of `digest`, kept in memory (`_prefix_keep`),
        or None. A corrupt entry raises (the lookup counts a miss)."""
        store = self._prefix_disk_store()
        if store is None:
            return None
        blob = store.load_bytes(self._prefix_disk_key(digest))
        if blob is None:
            return None
        import torch

        with np.load(io.BytesIO(blob)) as z:
            row = [dict() for _ in range(int(z["n_layers"]))]
            for key in z.files:
                if not key.startswith("L"):
                    continue
                where, dt = key.split("|")
                i, name = where[1:].split("_", 1)
                t = torch.from_numpy(z[key].copy())
                if dt == "bfloat16":
                    t = t.view(torch.bfloat16)
                row[int(i)][name] = t
            prompt = np.asarray(z["prompt"], np.int32)
            logp = np.asarray(z["logp"], np.float32)
        return self._prefix_keep(digest, prompt, logp, tuple(row))

    def _prefix_keep(self, digest: str, prompt: np.ndarray, logp: np.ndarray,
                     row) -> tuple:
        """Keep an entry in memory: (the prompt, the logp at its last
        position, a host copy of the filled row, its handle in the infer
        cache), LRU-bounded. The infer cache keeps the row (`keep_row`,
        each rank its own under a model axis) and forgets it when it
        leaves the LRU."""
        handle = f"{id(self)}:{digest}"
        ic = self.net.infer_cache
        if self._forget is None:
            # the rows this batcher keeps leave the infer cache with it
            # (a follower's with rank 0's next header)
            self._forget = weakref.finalize(self, ic.forget_rows,
                                            f"{id(self)}:")
        host_row = ic.keep_row(handle, row)
        entry = (np.asarray(prompt, np.int32).copy(), logp, host_row, handle)
        dropped = []
        with self._cv:
            self._prefix_lru[digest] = entry
            self._prefix_lru.move_to_end(digest)
            while len(self._prefix_lru) > PREFIX_CACHE_ENTRIES:
                dropped.append(self._prefix_lru.popitem(last=False)[1][3])
        for h in dropped:
            ic.drop_row(h)
        return entry

    def _prefix_lookup(self, prompt: np.ndarray):
        """(matched tokens, logp or None, host row, its handle) for
        `prompt`, or None on a miss; logp only on an exact match. An exact
        miss in memory is looked up in the store (`_prefix_disk_load`). Any
        failure here (the armed `generate.prefix_lookup` fault, a corrupt
        disk entry) is a counted miss and a cold prefill: the stream never
        fails here."""
        try:
            faults.fire("generate.prefix_lookup",
                        prompt_tokens=int(prompt.shape[0]))
            digest = self._prefix_digest(prompt)
            with self._cv:
                entry = self._prefix_lru.get(digest)
                if entry is not None:
                    self._prefix_lru.move_to_end(digest)
            if entry is None:
                entry = self._prefix_disk_load(digest)
                if entry is not None:
                    with self._cv:
                        self._prefix_disk_hits += 1
            if entry is not None:
                with self._cv:
                    self._prefix_hits += 1
                return (int(entry[0].shape[0]), entry[1], entry[2],
                        entry[3])
            with self._cv:
                candidates = (list(self._prefix_lru.values())
                              if self.prefix_match == "longest" else [])
            best = None
            for p2, _, row2, handle in candidates:
                m = int(p2.shape[0])
                if (m < int(prompt.shape[0])
                        and (best is None or m > best[0])
                        and np.array_equal(p2, prompt[:m])):
                    best = (m, None, row2, handle)
            if best is not None:
                with self._cv:
                    self._prefix_hits += 1
                return best
        except Exception:  # noqa: BLE001 — a failed lookup is a miss
            pass
        with self._cv:
            self._prefix_misses += 1
        return None

    # -- slots ----------------------------------------------------------------
    def _vacate(self, slot: int) -> None:
        """Free `slot` and its pages, point its table row at the scratch
        page, and restart the ramp (the slot set changed)."""
        self._slots[slot] = None
        self._temps[slot] = 0.0
        # an empty row decodes at position 0, so a verify's K positions
        # stay inside the table
        self._pos[slot] = 0
        self._feed[slot] = []
        self._ramp = 1
        if self.paged:
            self._pool.free(self._page_table[slot])
            self._page_table[slot, :] = 0

    def _release_slot(self, slot: int, stream: GenerationStream,
                      error: Optional[BaseException] = None) -> None:
        stream._finish(error)
        self._vacate(slot)
        with self._cv:
            self._active -= 1
            if error is None:
                self._completed += 1
            else:
                self._failed += 1
            self._cv.notify_all()

    def _preempt_slot(self, slot: int, stream: GenerationStream) -> None:
        """Page-pool preemption (an overcommitted pool ran dry mid-decode):
        free the slot and its pages without finishing the stream, and queue
        it first to be recomputed from its prompt; the tokens it delivered
        are swallowed on the way (`GenerationStream._deliver`), so its
        consumer sees one whole stream. Freeing its pages lets the others
        grow, and a lone stream always fits (`n_pages >= pages_per_slot`)."""
        stream._replay = stream.tokens_emitted
        self._vacate(slot)
        with self._cv:
            self._active -= 1
            self._preempted += 1
            self._pending.appendleft(stream)
            self._cv.notify_all()

    def _fail_active(self, error: BaseException) -> None:
        for slot, stream in enumerate(self._slots):
            if stream is not None:
                self._release_slot(slot, stream, error=error)

    def _admit_pending(self) -> None:
        free = self._free_slots()
        if not self.continuous and len(free) != self.n_slots:
            return  # sequential: wait for the slowest slot
        for slot in free:
            with self._cv:
                if not self._pending:
                    return
                stream = self._pending.popleft()
            try:
                self._admit_one(slot, stream)
            except PagesExhausted:
                # pool pressure: the stream waits, pages free as streams
                # finish, and admission runs again every step
                with self._cv:
                    self._pending.appendleft(stream)
                return
            except BaseException as e:  # noqa: BLE001 — isolate the stream
                with self._cv:
                    self._failed += 1
                stream._finish(e)

    def _lazy_alloc(self, k: int, pos=None, steps=None) -> None:
        """Give every active slot pages for its next `k` positions. A dry
        pool preempts the one stream that could not grow; an armed
        `decode.page_alloc` fault ends that stream. The block loop passes
        its scheduled `pos` (the host's `_pos` lags it) and a per-slot
        `steps` (a slot scheduled no step takes no page)."""
        ps = self.page_size
        for slot, stream in enumerate(self._slots):
            if stream is None:
                continue
            kk = k if steps is None else int(steps[slot])
            if kk <= 0:
                continue
            p0 = int(self._pos[slot] if pos is None else pos[slot])
            need = [p for p in range(p0 // ps, (p0 + kk - 1) // ps + 1)
                    if p < self.pages_per_slot
                    and self._page_table[slot, p] == 0]
            if not need:
                continue
            try:
                got = self._pool.alloc(len(need), slot=slot, pos=p0)
            except PagesExhausted:
                self._preempt_slot(slot, stream)
                continue
            except BaseException as e:  # noqa: BLE001 — isolate the stream
                self._release_slot(slot, stream, error=e)
                continue
            for p, phys in zip(need, got):
                self._page_table[slot, p] = phys

    # -- one step a dispatch (decode-loop thread) ----------------------------
    def _decode_once(self) -> None:
        """One table step: the per-slot fault point (a raise ends THAT
        stream only), one decode call over every slot, then each slot's
        token delivered (or its next prompt token fed) and finished slots
        freed. With a draft, a speculative round (`_spec_once`) instead
        while no slot feeds prompt tokens and every slot has room for
        spec_k more; otherwise the draft steps over the same tokens, in
        lockstep."""
        import torch

        t0 = time.monotonic()
        for slot, stream in enumerate(self._slots):
            if stream is None:
                continue
            try:
                faults.fire("decode.step", slot=slot,
                            pos=int(self._pos[slot]))
            except BaseException as e:  # noqa: BLE001 — isolate the stream
                self._release_slot(slot, stream, error=e)
        active = [s for s, st in enumerate(self._slots) if st is not None]
        if not active:
            return
        if (self.spec_k and not any(self._feed[s] for s in active)
                and all(int(self._pos[s]) + self.spec_k <= self.max_seq
                        for s in active)):
            self._spec_once()
            return
        if self.paged:
            self._lazy_alloc(1)
            if not any(s is not None for s in self._slots):
                return
        ic, net = self.net.infer_cache, self.net
        try:
            if self.paged:
                tok2, keys2, _ = ic.decode_paged(
                    net.conf, net.params, self._state, self._tok,
                    self._pos, self._keys, self._temps, self._page_table)
            else:
                tok2, keys2, _ = ic.decode(
                    net.conf, net.params, self._state, self._tok,
                    self._pos, self._keys, self._temps)
            if self.draft_net is not None:
                self._draft_step(self._tok, self._pos)
            # one read-back for tokens and keys
            t_get = time.monotonic()
            both = torch.cat([tok2.long()[:, None], keys2], dim=1).cpu()
            wait = time.monotonic() - t_get
            tok2 = both[:, 0].numpy().astype(np.int32)
            keys2 = both[:, 1:].numpy().astype(np.uint32)
        except BaseException as e:  # noqa: BLE001 — no fallback: fail them
            self._fail_active(e)
            return
        now = time.monotonic()
        emitted = 0
        for slot, stream in enumerate(self._slots):
            if stream is None:
                continue
            if self._feed[slot]:
                # a prompt-feed step (longest match): the table consumed one
                # prompt token; its draw and key are dropped, so the key
                # stream stays a cold prefill's
                self._tok[slot] = self._feed[slot].pop(0)
                self._pos[slot] += 1
                continue
            first = stream.tokens_emitted == 0
            self._tok[slot] = tok2[slot]
            self._pos[slot] += 1
            self._keys[slot] = keys2[slot]
            if stream._deliver(int(tok2[slot]), now):
                emitted += 1
                if first:
                    with self._cv:
                        self._record_ttft_locked(stream)
            if (stream.tokens_emitted >= stream.max_new
                    or int(self._pos[slot]) >= self.max_seq):
                self._release_slot(slot, stream)
        self._note_block(1, time.monotonic() - t0, wait, emitted, now)

    def _note_block(self, k: int, wall: float, wait: float, emitted: int,
                    now: float) -> None:
        """Books of one dispatch (a step or a block): tokens and the
        trailing rate window, the block-size histogram, and the host's share
        (wall less the time spent waiting for the device's answer)."""
        with self._cv:
            self._note_locked(wall, wait, emitted, now)
            _hist_add(self._blk_hist, DECODE_BLOCK_STEPS_BOUNDS, k)

    def _note_locked(self, wall: float, wait: float, emitted: int,
                     now: float) -> None:
        """Tokens, the rate window and the host's share of one dispatch
        (the caller holds `_cv`)."""
        self._tokens_total += emitted
        self._recent_tokens.append((now, emitted))
        while (self._recent_tokens
               and now - self._recent_tokens[0][0] > RATE_WINDOW_S):
            self._recent_tokens.popleft()
        self._host_s += max(wall - wait, 0.0)
        self._wall_s += wall

    # -- speculative rounds (decode-loop thread) -----------------------------
    def _draft_carries(self) -> list:
        """The draft table's carry tensors, (h, c) a recurrent layer."""
        return [lay[name] for lay in self._draft_state
                for name in ("h", "c") if name in lay]

    def _draft_step(self, tok, pos):
        """One greedy draft decode over the draft's table (zero keys and
        temperatures, kept on its device), its carries written in place:
        the proposals, a device tensor."""
        dn = self.draft_net
        nxt, _, _ = dn.infer_cache.decode(
            dn.conf, dn.params, self._draft_state, tok, pos,
            *self._draft_zeros)
        return nxt

    def _spec_once(self) -> None:
        """One speculative round. The draft proposes spec_k - 1 tokens a
        slot, then steps once more so that its retained carries reach depth
        spec_k (a copy of its carries kept after each step; its tokens stay
        on the device). One verify over the table chain-samples spec_k
        target tokens against [current token, proposals] and rolls the
        target's carries back to each slot's accepted depth in the
        program. One read-back of (proposals, samples, keys), then each
        slot emits its samples up to the first proposal that disagrees
        with the sample before it (the budget cuts emission only), takes
        the key after the last accepted token, and the draft's carries are
        set to the copy at that depth (an empty slot keeps depth 0).

        Parity: sample i is conditioned on the tokens emitted before it,
        since the chain is cut where a proposal differs from the sample
        the stream emitted there, and the key advances once a token
        accepted, so the streams are the one-step path's at any
        temperature. Rejected K/V rows are written again before they are
        read. A failed draft step or verify ends every stream of the
        table; nothing falls back to one-step decoding."""
        import torch

        t0 = time.monotonic()
        ic, net = self.net.infer_cache, self.net
        k, nb = self.spec_k, self.n_slots
        dev = self.draft_net.device
        carries = self._draft_carries()
        try:
            ladder = [[t.clone() for t in carries]]
            cols = [_on_device(self._tok, dev)]
            pos = _on_device(self._pos, dev)
            cur = cols[0]
            for i in range(1, k + 1):
                cur = self._draft_step(cur, pos + (i - 1))
                ladder.append([t.clone() for t in carries])
                if i < k:
                    cols.append(cur)
            if self.paged:
                self._lazy_alloc(k)
                if not any(s is not None for s in self._slots):
                    return
            toks = torch.stack([c.to(torch.int32) for c in cols], dim=1)
            if self.paged:
                g, keys_all, _ = ic.verify_paged(
                    net.conf, net.params, self._state, toks, pos,
                    self._keys, self._temps, self._page_table)
            else:
                g, keys_all, _ = ic.verify(
                    net.conf, net.params, self._state, toks, pos,
                    self._keys, self._temps)
            # one read-back for the proposals, the samples and the keys
            t_get = time.monotonic()
            both = torch.cat([toks.to(g.device).long(), g.long(),
                              keys_all.reshape(nb, 2 * k)], dim=1).cpu()
            wait = time.monotonic() - t_get
        except BaseException as e:  # noqa: BLE001 — no fallback: fail them
            self._fail_active(e)
            return
        toks = both[:, :k].numpy().astype(np.int32)
        g = both[:, k:2 * k].numpy().astype(np.int32)
        keys_all = both[:, 2 * k:].numpy().astype(np.uint32).reshape(
            nb, k, 2)
        now = time.monotonic()
        e_idx = np.zeros((nb,), np.int64)
        emitted = 0
        accepted: List[int] = []
        done = []
        for slot, stream in enumerate(self._slots):
            if stream is None:
                continue
            e = 1
            while e < k and toks[slot, e] == g[slot, e - 1]:
                e += 1
            e_idx[slot] = e
            first = stream.tokens_emitted == 0
            sent = 0
            for j in range(e):
                if stream.tokens_emitted >= stream.max_new:
                    break  # accepted past the budget: not emitted
                if stream._deliver(int(g[slot, j]), now):
                    sent += 1
            emitted += sent
            accepted.append(sent)
            self._tok[slot] = g[slot, e - 1]
            self._keys[slot] = keys_all[slot, e - 1]
            self._pos[slot] += e
            if first and sent:
                with self._cv:
                    self._record_ttft_locked(stream)
            if (stream.tokens_emitted >= stream.max_new
                    or int(self._pos[slot]) >= self.max_seq):
                done.append((slot, stream))
        depth = torch.as_tensor(e_idx, device=dev)
        rows = torch.arange(nb, device=dev)
        with torch.no_grad():
            for j, t in enumerate(carries):
                t.copy_(torch.stack([lad[j] for lad in ladder])[depth, rows])
        # booked before the streams end, so that a stream's last round is
        # in the stats its consumer reads after it
        self._note_round(time.monotonic() - t0, wait, emitted, accepted,
                         now)
        for slot, stream in done:
            self._release_slot(slot, stream)

    def _note_round(self, wall: float, wait: float, emitted: int,
                    accepted: List[int], now: float) -> None:
        """Books of one speculative round: tokens, the host's share and
        the tokens each active slot accepted."""
        with self._cv:
            self._note_locked(wall, wait, emitted, now)
            self._spec_rounds += 1
            for c in accepted:
                _hist_add(self._accept_hist, ACCEPTED_TOKENS_BOUNDS, c)

    # -- K steps a dispatch, pipelined (decode-loop thread) ------------------
    def _has_pending(self) -> bool:
        with self._cv:
            return bool(self._pending)

    def _block_eligible(self) -> bool:
        """Blocks run only while the slot set is stable: with admissions
        waiting or prompt tokens to feed, K pins to 1 (`_decode_once`), so
        time to first token and the feed are the one-step loop's. A
        speculative batcher never runs them."""
        if self.k_max <= 1 or self.spec_k or any(self._feed):
            return False
        return not self._has_pending()

    def _next_k(self, max_rem: int) -> int:
        """The largest ladder K within the ramp and the longest remaining
        budget."""
        k = 1
        for v in self._k_ladder:
            if v <= self._ramp and v <= max_rem:
                k = v
        return k

    def _block_rounds(self) -> None:
        """Pipelined blocks: block N + 1 is dispatched before block N is
        read back, so the host's work of a block (delivery, books) overlaps
        the card's. Each slot's progress is scheduled on the host (pos and
        the remaining budget), and block N + 1's tokens and keys are block
        N's device outputs, chained without a read-back. The loop goes back
        to admission as soon as streams wait (after at most the one block in
        flight). A failed dispatch or read-back ends every stream in the
        table (after the block in flight is delivered); nothing falls back
        to one step a dispatch."""
        ic = self.net.infer_cache
        streams = list(self._slots)
        pos = self._pos.copy()
        rem = np.zeros((self.n_slots,), np.int32)
        for s, stream in enumerate(streams):
            if stream is not None:
                budget = (stream.max_new - stream.tokens_emitted
                          + stream._replay)
                rem[s] = max(0, min(budget, self.max_seq - int(pos[s])))
        tok, keys = self._tok.copy(), self._keys.copy()
        inflight = None
        t_mark = time.monotonic()
        while True:
            blk, error = None, None
            if int(rem.max(initial=0)) > 0 and not self._has_pending():
                try:
                    blk = self._dispatch_block(ic, streams, tok, keys, pos,
                                               rem)
                except BaseException as e:  # noqa: BLE001 — no fallback
                    error = e
                if blk is not None:
                    tok, keys = blk["tok"], blk["keys"]
            if inflight is not None:
                # the block in flight was computed whatever came after it
                try:
                    t_mark = self._readback_block(inflight, t_mark)
                except BaseException as e:  # noqa: BLE001 — no fallback
                    error = error or e
            if error is not None:
                self._fail_active(error)
                return
            inflight = blk
            if blk is None:
                return

    def _dispatch_block(self, ic, streams, tok, keys, pos, rem):
        """Dispatch one K-step block without blocking: the `decode.step`
        fault point for every scheduled position (a raise ends THAT stream
        before its rows go), pages for the whole block, then the block and
        its read-back, both enqueued. Advances the caller's scheduled pos
        and rem in place; returns the block in flight, or None when nothing
        was left to dispatch."""
        k = self._next_k(int(rem.max(initial=0)))
        for s, stream in enumerate(streams):
            if (stream is None or rem[s] <= 0
                    or self._slots[s] is not stream):
                continue
            try:
                for j in range(min(k, int(rem[s]))):
                    faults.fire("decode.step", slot=s, pos=int(pos[s]) + j,
                                block=k)
            except BaseException as e:  # noqa: BLE001 — isolate the stream
                self._release_slot(s, stream, error=e)
                rem[s] = 0
        if int(rem.max(initial=0)) <= 0:
            return None
        net = self.net
        if self.paged:
            self._lazy_alloc(k, pos=pos, steps=np.minimum(rem, k))
            for s, stream in enumerate(streams):
                if stream is not None and self._slots[s] is not stream:
                    rem[s] = 0  # preempted or failed while growing
            if int(rem.max(initial=0)) <= 0:
                return None
            toks, tok2, keys2, _ = ic.decode_multi_paged(
                net.conf, net.params, self._state, tok, pos, keys,
                self._temps, rem, self._page_table, k)
        else:
            toks, tok2, keys2, _ = ic.decode_multi(
                net.conf, net.params, self._state, tok, pos, keys,
                self._temps, rem, k)
        read = _BlockRead(toks, tok2, keys2)
        adv = np.minimum(rem, k).astype(np.int32)
        pos += adv
        rem -= adv
        self._ramp = min(self._ramp * 2, self.k_max)
        return {"k": k, "streams": streams, "read": read, "tok": tok2,
                "keys": keys2, "adv": adv, "pos_after": pos.copy()}

    def _readback_block(self, blk, t_mark: float) -> float:
        """Read back one block in flight (one wait on its event), then the
        host's part: delivery (replay-aware), time to first token, releases
        and the books. Returns the new wall-clock mark."""
        t_get = time.monotonic()
        toks, tok_last, keys_last = blk["read"].wait()
        wait = time.monotonic() - t_get
        now = time.monotonic()
        emitted = 0
        for s, stream in enumerate(blk["streams"]):
            if (stream is None or int(blk["adv"][s]) <= 0
                    or self._slots[s] is not stream):
                continue  # idle, or released or preempted since dispatch
            first = stream.tokens_emitted == 0
            sent_first = False
            for j in range(int(blk["adv"][s])):
                if stream._deliver(int(toks[j, s]), now):
                    emitted += 1
                    sent_first = sent_first or first
            self._tok[s] = tok_last[s]
            self._keys[s] = keys_last[s]
            self._pos[s] = blk["pos_after"][s]
            if sent_first:
                with self._cv:
                    self._record_ttft_locked(stream)
            if (stream.tokens_emitted >= stream.max_new
                    or int(self._pos[s]) >= self.max_seq):
                self._release_slot(s, stream)
        t_end = time.monotonic()
        self._note_block(blk["k"], t_end - t_mark, wait, emitted, now)
        return t_end

    def _decode_loop(self) -> None:
        while True:
            self._admit_pending()
            if any(s is not None for s in self._slots):
                if self._block_eligible():
                    self._block_rounds()
                else:
                    self._decode_once()
                continue
            with self._cv:
                if self._pending:
                    continue
                if self._stop:
                    return
                self._cv.wait(timeout=0.5)

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        """Generation counters for `/v1/stats`, with the JAX package's keys:
        slot occupancy, queue depth, tokens/s over the trailing window, TTFT
        percentiles and histogram, stream outcomes, the host's share of the
        decode dispatches, the page pool and the prefix cache where they
        are on (with a store attached, its `disk_hits`: the hits the store
        served), and the infer cache's fresh captures."""
        with self._cv:
            now = time.monotonic()
            recent = sum(c for t, c in self._recent_tokens
                         if now - t <= RATE_WINDOW_S)
            ttfts = sorted(self._ttfts)
            active = self._active
            out = {
                "slots": {"width": self.n_slots, "active": active,
                          "free": self.n_slots - active},
                "max_seq": self.max_seq,
                "prompt_buckets": list(self.prompt_buckets),
                "continuous": self.continuous,
                "queue_depth": len(self._pending),
                "streams": {"admitted": self._admitted,
                            "completed": self._completed,
                            "failed": self._failed},
                "tokens": self._tokens_total,
                "tokens_per_sec": round(
                    recent / min(max(now - self._t_start, 1e-9),
                                 RATE_WINDOW_S), 2),
                "ttft_ms": {
                    "p50": round(_percentile(ttfts, 0.50) * 1e3, 3),
                    "p99": round(_percentile(ttfts, 0.99) * 1e3, 3)},
                "ttft_hist_s": _hist_out(self._ttft_hist, LATENCY_BUCKETS_S),
                "steps_per_dispatch": self.k_max,
                "host_overhead_fraction": (
                    round(self._host_s / self._wall_s, 4)
                    if self._wall_s > 0 else 0.0),
                "decode_host_seconds_total": round(self._host_s, 6),
                "decode_block_steps": _hist_out(self._blk_hist,
                                                DECODE_BLOCK_STEPS_BOUNDS),
            }
            if self.paged:
                live_tokens = sum(int(self._pos[s])
                                  for s, st in enumerate(self._slots)
                                  if st is not None)
                out["kv_pages"] = {
                    "page_size": self.page_size,
                    "total": self.n_pages,
                    "free": self._pool.free_count,
                    "live": self._pool.live_count,
                    "live_tokens": live_tokens,
                    "live_bytes": self._pool.live_count * self._page_bytes(),
                    "preempted_streams": self._preempted}
            if self.prefix_cache_enabled:
                out["prefix_cache"] = {"hits": self._prefix_hits,
                                       "misses": self._prefix_misses,
                                       "entries": len(self._prefix_lru),
                                       "match": self.prefix_match}
                if self._prefix_disk_store() is not None:
                    # the hits the store served
                    out["prefix_cache"]["disk_hits"] = self._prefix_disk_hits
            if self.spec_k:
                h = self._accept_hist
                out["speculative"] = {
                    "k": self.spec_k, "rounds": self._spec_rounds,
                    "accepted_per_step": (round(h["sum"] / h["count"], 3)
                                          if h["count"] else 0.0),
                    "accepted_hist": _hist_out(h, ACCEPTED_TOKENS_BOUNDS)}
        out["fresh_compiles"] = self.net.infer_cache.stats.misses
        if self.draft_net is not None:
            # warmed means warmed end to end: the draft's captures count
            out["fresh_compiles"] += self.draft_net.infer_cache.stats.misses
        return out

    def _page_bytes(self) -> int:
        """Bytes of one physical K/V page over every attention layer."""
        return sum(2 * lay["k"][0].numel() * lay["k"].element_size()
                   for lay in (self._state or ()) if "k" in lay)

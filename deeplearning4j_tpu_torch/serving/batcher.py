"""Dynamic micro-batching for predicts, continuous batching for generation.

Counterpart of `MicroBatcher`, `GenerationStream` and `ContinuousBatcher`
in `deeplearning4j_tpu/serving/batcher.py`. Predict requests land on a
per-(feature shape, dtype) FIFO from any thread, and one dispatcher thread
drains them into a single `net.output()` call.

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

`ContinuousBatcher` runs autoregressive generation over a fixed table of
decode slots (Orca-style continuous batching): each table step is one
`InferCache.decode` over every slot (on CUDA, one graph replay), a stream
that finishes frees its slot, and the next queued stream is admitted into
it by a B = 1 prefill on the very next step. The default path only (the
JAX package's `decode.slots` 4, `decode.page_size` 0,
`decode.steps_per_dispatch` 1): a paged pool, the prefix cache,
speculative decoding and several steps a dispatch raise
NotImplementedError naming ROADMAP.md queue A item 8.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.reliability import (CircuitBreaker,
                                                  DeadlineExceeded, faults)

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

#: decode slots when the caller gives none (the JAX package's
#: `decode.slots` registry default; not yet measured on a GPU)
DEFAULT_SLOTS = 4

#: histogram bounds (seconds) of time to first token, the JAX package's
#: `le` upper bounds (+Inf implied)
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: histogram bounds of decode steps a dispatch (always 1 here: several
#: steps a dispatch are not ported)
DECODE_BLOCK_STEPS_BOUNDS = (1, 2, 4, 8, 16)


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


# -- continuous batching for autoregressive generation ----------------------

_UNPORTED = "is not ported to deeplearning4j_tpu_torch yet; see ROADMAP.md " \
            "queue A item 8"


def check_generation_options(page_size=None, n_pages=0, prefix_cache=False,
                             draft_net=None, spec_k=0,
                             steps_per_dispatch=None) -> None:
    """Raise NotImplementedError for a generation option off the default
    path (each names its part of ROADMAP.md queue A item 8); nothing falls
    back to the default path in its place."""
    if (page_size or 0) > 0 or n_pages:
        raise NotImplementedError(f"paged KV decoding (page_size > 0) "
                                  f"{_UNPORTED} (paged decode)")
    if prefix_cache:
        raise NotImplementedError(f"the prefix cache {_UNPORTED} "
                                  f"(prefill_logp and the prefix cache)")
    if draft_net is not None or spec_k:
        raise NotImplementedError(f"speculative decoding (draft_net, "
                                  f"spec_k) {_UNPORTED} (verify_chunk)")
    if steps_per_dispatch is not None and int(steps_per_dispatch) != 1:
        if int(steps_per_dispatch) < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{steps_per_dispatch}")
        raise NotImplementedError(f"several decode steps a dispatch "
                                  f"(steps_per_dispatch > 1) {_UNPORTED} "
                                  f"(decode_block)")


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
        self._counted_admit = False
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self._q: "queue.Queue" = queue.Queue()

    # decode-loop side ------------------------------------------------------
    def _deliver(self, tok: int, now: float) -> None:
        if self.t_first is None:
            self.t_first = now
        self.tokens_emitted += 1
        self._q.put(int(tok))

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


class ContinuousBatcher:
    """A fixed-width table of decode slots with admission every step
    (continuous batching).

    Every table step is ONE `InferCache.decode` call over all `n_slots`
    rows; a stream that finishes frees its slot, and the next queued stream
    is admitted into it (a B = 1 prefill that also draws its first token,
    then its row copied into the table) before the next step, instead of
    waiting for its longest neighbour. `continuous=False` admits only when
    EVERY slot is free, so each wave waits for its longest stream.

    Rows are independent (each slot has its own K/V rows, LSTM carries and
    key), so packing never changes a stream's tokens. The table and the
    admission row are the infer cache's own states (`decode_state`), the
    ones `MultiLayerNetwork.warmup_generate` captures on. A fault at the
    `decode.step` point ends that slot's stream only, one at
    `generate.admit` the admitted stream only; a failed decode call (a
    capture that raises included) ends every stream it was decoding, and
    nothing falls back to another path.

    The JAX package's paged pool, prefix cache, speculative decoding and
    several steps a dispatch are not ported: those arguments raise
    NotImplementedError (ROADMAP.md queue A item 8)."""

    def __init__(self, net, n_slots: Optional[int] = None, max_seq: int = 64,
                 prompt_buckets: Tuple[int, ...] = (8,),
                 max_pending: int = 64, continuous: bool = True,
                 auto_start: bool = True, page_size: Optional[int] = None,
                 n_pages: int = 0, prefix_cache: bool = False,
                 draft_net=None, spec_k: int = 0,
                 steps_per_dispatch: Optional[int] = None):
        from deeplearning4j_tpu_torch.nn import decode as decode_mod

        check_generation_options(page_size, n_pages, prefix_cache,
                                 draft_net, spec_k, steps_per_dispatch)
        self.net = net
        self.n_slots = DEFAULT_SLOTS if n_slots is None else int(n_slots)
        self.max_seq = int(max_seq)
        self.prompt_buckets = tuple(sorted(
            int(b) for b in prompt_buckets if int(b) <= self.max_seq))
        self.max_pending = int(max_pending)
        self.continuous = bool(continuous)
        self._auto_start = auto_start
        decode_mod.check_generative(net.conf)
        # a learned positional table is gathered at P[pos] with no bound
        # check on the device, so the table edge (`submit` clamps max_new
        # to max_seq - n) must lie within it
        bound = decode_mod.positional_bound(net.conf)
        if bound and self.max_seq > bound:
            raise ValueError(
                f"max_seq={self.max_seq} exceeds the learned positional "
                f"table (max_seq_len={bound}); decoding past it would read "
                f"P[pos] out of range")
        self._cv = threading.Condition()
        self._pending: Deque[GenerationStream] = deque()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # -- slot table (decode-loop thread only) --------------------------
        self._state = None                 # [n_slots] rows, on the device
        self._row = None                   # the B = 1 admission row
        self._slots: List[Optional[GenerationStream]] = [None] * self.n_slots
        self._tok = np.zeros((self.n_slots,), np.int32)
        self._pos = np.zeros((self.n_slots,), np.int32)
        self._keys = np.zeros((self.n_slots, 2), np.uint32)
        self._temps = np.zeros((self.n_slots,), np.float32)
        # -- stats (under _cv's lock) --------------------------------------
        self._t_start = time.monotonic()
        self._tokens_total = 0
        self._admitted = 0
        self._completed = 0
        self._failed = 0
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
        with self._cv:
            if self._thread is not None:
                return self
            self._stop = False
            if self._state is None:
                ic, net = self.net.infer_cache, self.net
                self._state = ic.claim_decode_state(
                    net.conf, self.n_slots, self.max_seq, net.device,
                    "table")
                self._row = ic.claim_decode_state(
                    net.conf, 1, self.max_seq, net.device, "row")
                ic.reset_state(self._state)
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

    # -- decode loop (one thread) -------------------------------------------
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
        token), then the row is copied into the slot."""
        ic, net = self.net.infer_cache, self.net
        faults.fire("generate.admit", slot=slot,
                    prompt_tokens=int(stream.prompt.shape[0]))
        n = int(stream.prompt.shape[0])
        prompt = np.zeros((1, self._prompt_bucket(n)), np.int32)
        prompt[0, :n] = stream.prompt
        ic.reset_state(self._row)
        t0, keys1, row = ic.prefill(
            net.conf, net.params, self._row, prompt,
            np.asarray([n], np.int32), stream.key[None],
            np.asarray([stream.temperature], np.float32))
        tok0 = int(t0[0])
        key1 = keys1[0].cpu().numpy().astype(np.uint32)
        self._scatter_row(slot, row)
        self._slots[slot] = stream
        self._temps[slot] = stream.temperature
        self._tok[slot] = tok0
        self._pos[slot] = n
        self._keys[slot] = key1
        now = time.monotonic()
        stream._deliver(tok0, now)
        with self._cv:
            if not stream._counted_admit:
                stream._counted_admit = True
                self._admitted += 1
            self._active += 1
            self._tokens_total += 1
            self._recent_tokens.append((now, 1))
            self._record_ttft_locked(stream)
        if stream.tokens_emitted >= stream.max_new:
            self._release_slot(slot, stream)

    def _record_ttft_locked(self, stream: GenerationStream) -> None:
        """Books of a stream's first token (the caller holds `_cv`)."""
        self._ttfts.append(stream.ttft_s)
        _hist_add(self._ttft_hist, LATENCY_BUCKETS_S, stream.ttft_s)

    def _scatter_row(self, slot: int, row) -> None:
        """Copy a B = 1 row state into the table's row `slot`, tensor by
        tensor, on the device."""
        import torch

        from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

        with torch.no_grad():
            for tbl, r in zip(tree_leaves(self._state), tree_leaves(row)):
                tbl[slot].copy_(r[0])

    def _release_slot(self, slot: int, stream: GenerationStream,
                      error: Optional[BaseException] = None) -> None:
        stream._finish(error)
        self._slots[slot] = None
        self._temps[slot] = 0.0
        with self._cv:
            self._active -= 1
            if error is None:
                self._completed += 1
            else:
                self._failed += 1
            self._cv.notify_all()

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
            except BaseException as e:  # noqa: BLE001 — isolate the stream
                with self._cv:
                    self._failed += 1
                stream._finish(e)

    def _decode_once(self) -> None:
        """One table step: the per-slot fault point (a raise ends THAT
        stream only), one decode call over every slot, then each slot's
        token delivered and finished slots freed."""
        t0 = time.monotonic()
        for slot, stream in enumerate(self._slots):
            if stream is None:
                continue
            try:
                faults.fire("decode.step", slot=slot,
                            pos=int(self._pos[slot]))
            except BaseException as e:  # noqa: BLE001 — isolate the stream
                self._release_slot(slot, stream, error=e)
        if not any(s is not None for s in self._slots):
            return
        import torch

        net = self.net
        try:
            tok2, keys2, self._state = net.infer_cache.decode(
                net.conf, net.params, self._state, self._tok, self._pos,
                self._keys, self._temps)
            # one read-back for tokens and keys
            t_get = time.monotonic()
            both = torch.cat([tok2.long()[:, None], keys2], dim=1).cpu()
            wait = time.monotonic() - t_get
            tok2 = both[:, 0].numpy().astype(np.int32)
            keys2 = both[:, 1:].numpy().astype(np.uint32)
        except BaseException as e:  # noqa: BLE001 — no fallback: fail them
            for slot, stream in enumerate(self._slots):
                if stream is not None:
                    self._release_slot(slot, stream, error=e)
            return
        now = time.monotonic()
        emitted = 0
        for slot, stream in enumerate(self._slots):
            if stream is None:
                continue
            self._tok[slot] = tok2[slot]
            self._pos[slot] += 1
            self._keys[slot] = keys2[slot]
            stream._deliver(int(tok2[slot]), now)
            emitted += 1
            if (stream.tokens_emitted >= stream.max_new
                    or int(self._pos[slot]) >= self.max_seq):
                self._release_slot(slot, stream)
        wall = time.monotonic() - t0
        with self._cv:
            self._tokens_total += emitted
            self._recent_tokens.append((now, emitted))
            while (self._recent_tokens
                   and now - self._recent_tokens[0][0] > RATE_WINDOW_S):
                self._recent_tokens.popleft()
            self._host_s += max(wall - wait, 0.0)
            self._wall_s += wall
            _hist_add(self._blk_hist, DECODE_BLOCK_STEPS_BOUNDS, 1)

    def _decode_loop(self) -> None:
        while True:
            self._admit_pending()
            if any(s is not None for s in self._slots):
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
        decode dispatches and the infer cache's fresh captures."""
        with self._cv:
            now = time.monotonic()
            recent = sum(c for t, c in self._recent_tokens
                         if now - t <= RATE_WINDOW_S)
            ttfts = sorted(self._ttfts)
            h, bh = self._ttft_hist, self._blk_hist
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
                "ttft_hist_s": {"bounds": list(LATENCY_BUCKETS_S),
                                "counts": list(h["counts"]), "inf": h["inf"],
                                "sum": h["sum"], "count": h["count"]},
                "steps_per_dispatch": 1,
                "host_overhead_fraction": (
                    round(self._host_s / self._wall_s, 4)
                    if self._wall_s > 0 else 0.0),
                "decode_host_seconds_total": round(self._host_s, 6),
                "decode_block_steps": {
                    "bounds": list(DECODE_BLOCK_STEPS_BOUNDS),
                    "counts": list(bh["counts"]), "inf": bh["inf"],
                    "sum": bh["sum"], "count": bh["count"]},
            }
        out["fresh_compiles"] = self.net.infer_cache.stats.misses
        return out

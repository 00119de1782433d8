"""HTTP front of the micro-batching gateway.

Counterpart of `ModelServer` in `deeplearning4j_tpu/serving/server.py`:

  POST /v1/predict   {"features": [[...], ...], "dtype": "float32"?,
                      "deadline_ms": 250?, "priority": "interactive"|"batch"?}
                     -> {"output": [...], "rows": n}
                     (400 for malformed input, token ids outside the
                     vocabulary included, checked before it reaches the
                     device; 503 when the queue is full or the server is draining,
                     504 past `request_timeout_s` or the request's deadline)
  POST /v1/generate  {"prompt": [ids...], "max_new_tokens": 16?,
                      "temperature": 0.0?, "rng_seed": 0?}
                     -> 200, a chunked stream of {"token": id} JSON lines
                     ending with {"done": true, "tokens": n, "ttft_ms": ...}
                     (servers made with `generate=True` only; 404 without).
                     Failures before the first token are JSON errors (400
                     bad prompt, 503 overloaded or draining, 504 timed out,
                     500 a prefill fault); a fault after it ends THIS stream
                     with an {"error": ..., "done": true} line while the
                     other decode slots go on.
  GET  /v1/stats     gateway counters (queue depth, batch-size histogram,
                     latency percentiles, rows/s, breaker state), the
                     device the network runs on, the serving plan
                     (`ShardPlan.describe()`: axes, sizes, policy), the
                     resident programs, the process's kernel launches
                     (`kernel_launches`), the `tuning` block
                     (`optimize/tunables.status()`) and, with a generator,
                     its `generation` block
  GET  /metrics      the same counters as Prometheus text
                     (`serving/metrics.replica_metrics`)

Under a serving mesh (`MultiLayerNetwork.set_serve_mesh`) the server runs
on rank 0 alone, the one HTTP front: its batchers' calls reach the other
ranks through the infer cache, which runs there in `follow`.
  GET  /healthz      liveness: 200 while the process can answer at all
  GET  /readyz       readiness: 200 once started and not draining

Handler threads only parse JSON and park on a batcher; each batcher's one
thread makes its device calls. With `batching=False` each handler thread
calls `net.output` itself: no coalescing, and the network's captured graphs
replay one at a time under their pool's lock. `default_deadline_ms` is the
deadline of a request that names none (a 504 past it, on the batched
path). `drain()` stops admitting work,
stops the accept loop, waits for in-flight handlers, then stops the batcher,
which serves every queued request first.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from deeplearning4j_tpu_torch.nd import kernels
from deeplearning4j_tpu_torch.nd.platform import device_kind
from deeplearning4j_tpu_torch.reliability import (CircuitBreaker,
                                                  DeadlineExceeded)
from deeplearning4j_tpu_torch.serving.batcher import (PRIORITIES,
                                                      ContinuousBatcher,
                                                      MicroBatcher,
                                                      ServerOverloaded)


class ServerDraining(RuntimeError):
    """The server is shutting down and no longer accepts work (503)."""


class _ServeHandler(BaseHTTPRequestHandler):
    model_server: "ModelServer" = None

    def _send(self, body, code: int = 200) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    def do_GET(self):  # noqa: N802
        path = urlparse(self.path).path
        ms = self.model_server
        if path == "/v1/stats":
            self._send(ms.stats())
        elif path == "/metrics":
            from deeplearning4j_tpu_torch.serving.metrics import (
                CONTENT_TYPE, replica_metrics)
            data = replica_metrics(ms.stats()).encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif path == "/healthz":
            self._send({"ok": True})
        elif path == "/readyz":
            if ms.is_ready():
                self._send({"ready": True})
            else:
                self._send({"ready": False, "draining": ms.draining}, 503)
        else:
            self._send({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802
        path = urlparse(self.path).path
        if path == "/v1/generate":
            self._do_generate()
            return
        if path != "/v1/predict":
            self._send({"error": "not found"}, 404)
            return
        ms = self.model_server
        if not ms.enter_request():
            self._send({"error": "draining: server is shutting down"}, 503)
            return
        try:
            try:
                body = self._body()
                feats = np.asarray(body["features"],
                                   dtype=body.get("dtype", "float32"))
                deadline_ms = body.get("deadline_ms")
                if deadline_ms is not None:
                    deadline_ms = float(deadline_ms)
                priority = body.get("priority", "interactive")
                if priority not in PRIORITIES:
                    raise ValueError(
                        f"priority must be one of {PRIORITIES}; "
                        f"got {priority!r}")
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._send({"error": f"bad request: {e}"}, 400)
                return
            if feats.ndim == 1:  # single example: make it a 1-row batch
                feats = feats[None, :]
            try:
                out = ms.predict(feats, deadline_ms=deadline_ms,
                                 priority=priority)
            except ValueError as e:  # input the network cannot take
                self._send({"error": f"bad request: {e}"}, 400)
                return
            except ServerOverloaded as e:
                self._send({"error": f"overloaded: {e}"}, 503)
                return
            except ServerDraining as e:
                self._send({"error": f"draining: {e}"}, 503)
                return
            except DeadlineExceeded as e:
                self._send({"error": f"deadline exceeded: {e}"}, 504)
                return
            except TimeoutError as e:
                self._send({"error": f"timed out: {e}"}, 504)
                return
            self._send({"output": np.asarray(out).tolist(),
                        "rows": int(feats.shape[0])})
        finally:
            ms.exit_request()

    def _chunk(self, obj) -> None:
        """One chunked-transfer frame holding one JSON line."""
        data = (json.dumps(obj) + "\n").encode()
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    def _do_generate(self) -> None:
        """POST /v1/generate: tokens streamed one a chunk. The status is
        decided by the first token: a failure before it is a JSON error
        with its 4xx/5xx; from it on the answer is a 200 stream, and a
        fault of THIS stream ends it with an {"error", "done": true}
        line."""
        ms = self.model_server
        if ms.generator is None:
            self._send({"error": "generation not enabled on this server "
                                 "(start with generate=True / --generate)"},
                       404)
            return
        if not ms.enter_request():
            self._send({"error": "draining: server is shutting down"}, 503)
            return
        try:
            try:
                body = self._body()
                prompt = [int(t) for t in body["prompt"]]
                max_new = int(body.get("max_new_tokens", 16))
                temperature = float(body.get("temperature", 0.0))
                rng_seed = int(body.get("rng_seed", 0))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._send({"error": f"bad request: {e}"}, 400)
                return
            try:
                stream = ms.generate_stream(prompt, max_new_tokens=max_new,
                                            temperature=temperature,
                                            rng_seed=rng_seed)
            except ValueError as e:
                self._send({"error": f"bad request: {e}"}, 400)
                return
            except ServerOverloaded as e:
                self._send({"error": f"overloaded: {e}"}, 503)
                return
            except ServerDraining as e:
                self._send({"error": f"draining: {e}"}, 503)
                return
            it = stream.tokens(timeout=ms.request_timeout_s)
            try:
                first = next(it)
            except StopIteration:
                self._send({"error": "stream produced no tokens"}, 500)
                return
            except TimeoutError as e:
                self._send({"error": f"timed out: {e}"}, 504)
                return
            except ServerOverloaded as e:
                self._send({"error": f"overloaded: {e}"}, 503)
                return
            except Exception as e:  # noqa: BLE001 — an admission fault
                self._send({"error": f"generation failed: {e}"}, 500)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                self._chunk({"token": first})
                for tok in it:
                    self._chunk({"token": tok})
                ttft = stream.ttft_s
                self._chunk({"done": True,
                             "tokens": stream.tokens_emitted,
                             "ttft_ms": (None if ttft is None
                                         else round(ttft * 1e3, 3))})
            except Exception as e:  # noqa: BLE001 — a fault mid-stream
                self._chunk({"error": f"generation failed: {e}",
                             "done": True})
            self.wfile.write(b"0\r\n\r\n")
        finally:
            ms.exit_request()

    def log_message(self, *args):  # quiet
        pass


class ModelServer:
    """Serve a `MultiLayerNetwork` over HTTP through the micro-batcher, and
    with `generate=True` POST /v1/generate through a `ContinuousBatcher`
    (`gen_slots` slots, a `gen_max_seq`-token table, one prefill program per
    `gen_prompt_buckets` bucket; `gen_page_size`, `gen_pages`,
    `gen_prefix_cache`, `gen_prefix_match`, `gen_draft`, `gen_spec_k` and
    `gen_steps_per_dispatch` are its paged pool, prefix cache, speculative
    decoding's draft net and chunk, and steps a dispatch).

    `batching=False` bypasses the micro-batcher (each handler thread calls
    `net.output`), as in the JAX package. `default_deadline_ms` applies to
    requests that carry no `deadline_ms` (None: they wait up to
    `request_timeout_s`)."""

    def __init__(self, net, host: str = "127.0.0.1", port: int = 0,
                 max_delay_ms: Optional[float] = None,
                 max_pending: int = 1024,
                 max_batch_rows: Optional[int] = None,
                 batching: bool = True,
                 request_timeout_s: float = 30.0,
                 drain_timeout_s: float = 10.0,
                 default_deadline_ms: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 generate: bool = False,
                 gen_slots: Optional[int] = None,
                 gen_max_seq: int = 64,
                 gen_prompt_buckets=(8,),
                 gen_max_pending: int = 64,
                 gen_page_size: Optional[int] = None,
                 gen_pages: int = 0,
                 gen_prefix_cache: bool = False,
                 gen_prefix_match: str = "exact",
                 gen_draft=None, gen_spec_k: int = 0,
                 gen_steps_per_dispatch: Optional[int] = None):
        self.net = net
        self.batching = bool(batching)
        self.request_timeout_s = float(request_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.default_deadline_ms = default_deadline_ms
        self.batcher = MicroBatcher(
            net, max_delay_ms=max_delay_ms, max_pending=max_pending,
            max_batch_rows=max_batch_rows, auto_start=False,
            breaker=breaker)
        self.generator: Optional[ContinuousBatcher] = (
            ContinuousBatcher(net, n_slots=gen_slots, max_seq=gen_max_seq,
                              prompt_buckets=gen_prompt_buckets,
                              max_pending=gen_max_pending, auto_start=False,
                              page_size=gen_page_size, n_pages=gen_pages,
                              prefix_cache=gen_prefix_cache,
                              prefix_match=gen_prefix_match,
                              draft_net=gen_draft, spec_k=gen_spec_k,
                              steps_per_dispatch=gen_steps_per_dispatch)
            if generate else None)
        handler = type("Handler", (_ServeHandler,), {"model_server": self})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()
        self._ready = False
        self._draining = False
        self._drained = False
        self._inflight = 0
        self._stop_requested = threading.Event()

    # -- request bookkeeping (handler threads) -------------------------------
    @property
    def draining(self) -> bool:
        with self._state_lock:
            return self._draining

    def is_ready(self) -> bool:
        with self._state_lock:
            return self._ready and not self._draining

    def enter_request(self) -> bool:
        """Admit a request: False once draining."""
        with self._state_lock:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def exit_request(self) -> None:
        with self._state_lock:
            self._inflight -= 1

    def predict(self, feats: np.ndarray,
                deadline_ms: Optional[float] = None,
                priority: str = "interactive") -> np.ndarray:
        if self.draining:
            raise ServerDraining("server is draining")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if self.batching:
            return self.batcher.predict(feats,
                                        timeout=self.request_timeout_s,
                                        deadline_ms=deadline_ms,
                                        priority=priority)
        return self.net.output(feats).float().cpu().numpy()

    def generate_stream(self, prompt, max_new_tokens: int = 16,
                        temperature: float = 0.0, rng_seed: int = 0):
        """Submit a generation request to the continuous batcher and return
        its `GenerationStream`."""
        if self.generator is None:
            raise RuntimeError("generation not enabled (generate=True)")
        if self.draining:
            raise ServerDraining("server is draining")
        return self.generator.submit(prompt, max_new_tokens=max_new_tokens,
                                     temperature=temperature,
                                     rng_seed=rng_seed)

    def stats(self) -> dict:
        out = self.batcher.stats()
        out["batching"] = self.batching
        out["device"] = {"type": self.net.device.type,
                         "kind": device_kind(self.net.device)}
        out["plan"] = self.net.infer_cache.plan.describe()
        out["programs"] = self.net.infer_cache.programs_summary()
        # the process's kernel launches by kernel and by forward tile
        # variant (`nd/kernels.launch_snapshot`; a replay counts what its
        # capture launched)
        out["kernel_launches"] = kernels.launch_snapshot()
        if self.generator is not None:
            out["generation"] = self.generator.stats()
        with self._state_lock:
            out["ready"] = self._ready and not self._draining
            out["draining"] = self._draining
            out["inflight"] = self._inflight
        out["drain_timeout_s"] = self.drain_timeout_s
        return out

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "ModelServer":
        self.batcher.start()
        if self.generator is not None:
            self.generator.start()
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        with self._state_lock:
            self._ready = True
        return self

    def request_stop(self) -> None:
        """Signal-handler-safe stop request: only sets an event; the thread
        parked in `wait_for_stop()` runs the drain."""
        self._stop_requested.set()

    def wait_for_stop(self, timeout: Optional[float] = None) -> bool:
        return self._stop_requested.wait(timeout)

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Graceful shutdown, bounded by `timeout_s` (default
        `drain_timeout_s`); idempotent."""
        timeout = self.drain_timeout_s if timeout_s is None else float(
            timeout_s)
        with self._state_lock:
            if self._drained:
                return
            self._drained = True
            self._draining = True
        self._stop_requested.set()
        deadline = time.monotonic() + timeout
        if self._thread is not None:
            self.server.shutdown()  # accept loop exits; sockets stay open
        while time.monotonic() < deadline:
            with self._state_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.005)
        self.batcher.stop(timeout=max(deadline - time.monotonic(), 1.0))
        if self.generator is not None:
            # running streams decode to their end (bounded by the table),
            # queued ones are served like queued predicts
            self.generator.stop(timeout=max(deadline - time.monotonic(),
                                            1.0))
        self.server.server_close()

    def stop(self) -> None:
        self.drain()

    @property
    def url(self) -> str:
        return f"http://{self.server.server_address[0]}:{self.port}"

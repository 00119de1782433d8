"""Profiling, tracing, and metrics.

The port of `deeplearning4j_tpu/utils/profiling.py`. The reference's
observability is wall-clock job timing (`WorkerActor.java:199-203` "Job
took X ms"), iteration listeners (`ScoreIterationListener.java:43-46`),
named counters in the state tracker (`StateTracker.increment/count`,
`StateTracker.java:54-56`), and the YARN `metricsReport(map<string,long>)`
RPC (`IterativeReduceService.java:28`).

`StepTimer`, `MetricsRegistry`, `METRICS` and `TimingIterationListener`
are the JAX package's, unchanged. `ThroughputMeter` waits for the device
where JAX calls `jax.block_until_ready`: `torch.cuda.synchronize` of each
CUDA device its registered results lie on, nothing for CPU tensors.
`Tracer` records with `torch.profiler` (CPU activity, and CUDA activity
when its device is a card) through `optimize/profiling.chrome_trace`, and
writes a Chrome trace (chrome://tracing, Perfetto) into `trace_dir`;
`Tracer.annotate(name)` is `torch.profiler.record_function`, a named span
in that trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time
from typing import Dict, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


class StepTimer:
    """Wall-clock step timing ("Job took X ms" parity) with summary stats."""

    def __init__(self, name: str = "step", log_each: bool = False):
        self.name = name
        self.log_each = log_each
        self.times_ms = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_ms = (time.perf_counter() - self._t0) * 1e3
        self.times_ms.append(dt_ms)
        if self.log_each:
            log.info("%s took %.2f ms", self.name, dt_ms)
        return False

    @property
    def mean_ms(self) -> float:
        return sum(self.times_ms) / len(self.times_ms) if self.times_ms else 0.0

    def summary(self) -> Dict[str, float]:
        ts = sorted(self.times_ms)
        if not ts:
            return {"count": 0}
        return {
            "count": len(ts),
            "mean_ms": self.mean_ms,
            "min_ms": ts[0],
            "p50_ms": ts[len(ts) // 2],
            "max_ms": ts[-1],
        }


def _sync_devices(results) -> None:
    """Wait for the work behind every CUDA tensor in `results` (nested
    tuples, lists and dicts), once per device; CPU tensors are ready."""
    import torch

    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    devices = {leaf.device for leaf in tree_leaves(results)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class ThroughputMeter:
    """samples/sec over device-blocking steps (timings measure compute).

    The with-body registers its device result via `block(...)` so the
    timer can synchronize on work created *inside* the block (CUDA launches
    are asynchronous; without the sync only launch latency would be
    measured):

        with meter.measure(batch) as m:
            m.block(step(params, x))
    """

    class _Measurement:
        def __init__(self):
            self._results = []

        def block(self, result):
            """Register a device value to synchronize on; returns it."""
            self._results.append(result)
            return result

    def __init__(self):
        self.samples = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, batch_size: int):
        m = self._Measurement()
        t0 = time.perf_counter()
        yield m
        if m._results:
            _sync_devices(m._results)
        self.seconds += time.perf_counter() - t0
        self.samples += batch_size

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.seconds if self.seconds > 0 else 0.0


def default_trace_dir() -> str:
    """`dl4j_tpu_torch_trace` under the temporary directory ($TMPDIR)."""
    return os.path.join(tempfile.gettempdir(), "dl4j_tpu_torch_trace")


class Tracer:
    """`torch.profiler` trace capture (a Chrome trace, `trace_path`) +
    named annotations. `device` says which activities are recorded: CUDA
    (the default, which needs a card) records the kernels too; "cpu"
    records the host's ops only."""

    def __init__(self, trace_dir: Optional[str] = None, device=None):
        from deeplearning4j_tpu_torch.nd.platform import resolve_device

        self.trace_dir = trace_dir or default_trace_dir()
        self.device = resolve_device(device)
        self.trace_path: Optional[str] = None
        self._session = None

    def start(self) -> None:
        from deeplearning4j_tpu_torch.optimize.profiling import chrome_trace

        if self._session is None:
            self._session = chrome_trace(self.trace_dir,
                                         cuda=self.device.type == "cuda")
            self.trace_path = self._session.__enter__()

    def stop(self) -> None:
        if self._session is not None:
            session, self._session = self._session, None
            session.__exit__(None, None, None)

    @contextlib.contextmanager
    def trace(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    @staticmethod
    def annotate(name: str):
        """Named region visible in the trace viewer."""
        import torch

        return torch.profiler.record_function(name)


class MetricsRegistry:
    """Named counters + gauges (StateTracker.increment / YARN
    metricsReport parity), thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    def increment(self, name: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + by

    def count(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def report(self) -> Dict[str, float]:
        """metricsReport(map<string,long>) parity — one flat dict."""
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            return out


METRICS = MetricsRegistry()  # process-global default registry


class TimingIterationListener:
    """IterationListener recording inter-iteration wall time into METRICS."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or METRICS
        self._last: Optional[float] = None

    def iteration_done(self, model, iteration: int, score: float) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.registry.increment("iteration_ms_total",
                                    (now - self._last) * 1e3)
        self.registry.increment("iterations")
        self.registry.gauge("last_score", score)
        self._last = now

"""Captured train steps: capture once, replay many.

Counterpart of `deeplearning4j_tpu/optimize/step_cache.py`. The JAX
package compiles one XLA program per (conf, algorithm, batch shape) and
reuses it for every batch; here the program is a `torch.cuda.CUDAGraph`:

  key schema    (kind, conf fingerprint, algorithm, arg shapes/dtypes), the
                JAX package's schema; `conf_fingerprint` is the same sha1
                of `conf.to_json()`, so equal confs key alike in both
                packages.
  capture       on a miss, the program runs `WARMUP_CALLS` times on a side
                stream (kernel libraries load and `cudaFuncSetAttribute`
                runs there, outside any capture), then once under
                `torch.cuda.graph` into the network's memory pool
                (`GraphPool`). Batch data enters through static input
                tensors, which each call fills before the replay. A capture
                that fails raises `GraphCaptureError`: nothing falls back to
                the eager path.
  params        a graph reads params from the storage it was captured
                with, so the train step ends by writing its result into the
                network's param tensors in place. A program whose params
                have moved (another tree was assigned) is captured anew.
  bucketing     a batch pads with zero rows up to the smallest known bucket
                that fits (buckets grow from the sizes seen), and pad rows
                carry row weight 0 in the loss and in BatchNorm's moments,
                as in the JAX package; an epoch with a ragged tail captures
                at most n_buckets graphs.
  keys          a conf with dropout takes the step's threefry key as one
                more static input (int64 [2]), copied in before each
                replay, so the masks are drawn inside the graph.
  BatchNorm     the program advances the running EMA after the solver from
                the last live iteration's moments, and writes it into the
                EMA leaves in place with the params: the inference graphs,
                which read those leaves by address, see it at once.
  launches      the kernel wrappers count launches on the host
                (`nd/kernels.LAUNCHES`, `TILE_LAUNCHES` by forward tile
                variant); the warm-up and capture launches
                are taken back and each replay adds what its capture
                launched.
  segments      a line-searched solver (GD, CG, LBFGS) cannot be one graph:
                its search is a data-dependent loop. Its program is a
                `solver.LineSearchRun` whose segments (init; gradient,
                direction and first probe; halve and probe; step; and the
                write of the result into the params) are captured as one
                graph each over state tensors that stay in place, and the
                host replays them, reading one small tensor per probe.
                `stats.solver` counts the graphs captured and replayed, the
                probes and the reads of the last run.
  pretraining   `pretrain` runs a layer's solver on its own input, one
                program per (layer index, layer conf, algorithm, input
                shape), unbucketed, as in the JAX package; the layer's
                params are written in place. RBMs and corrupting
                autoencoders take their key as a static input.
  CPU           (which a caller must ask for) the same program function
                runs eagerly on every call, with the same keys, buckets,
                padding and books, so the CPU tests reach all of it. So
                does a cache whose `capture` is False, on any device: the
                captured programs run uncaptured.

  data-parallel the trainer's steps (`parallel/data_parallel.py`) are
                programs of a `DPStepCache` (kind "dp-step-cache", the JAX
                package's name): one graph per (variant, conf, shapes), the
                variants sync, masked, grad_accum, averaging and zero1. The
                graph reads the trainer's flat param and updater buffers by
                address and writes the step into them in place; the
                iteration's updater constants and the key are static
                inputs, and the collectives run inside the graph.

`StepCacheStats.as_dict` keeps the JAX package's keys: `compile_seconds`
holds capture seconds (warm-up included), and the disk counters stay 0, as
a CUDA graph cannot be written to disk (ROADMAP.md queue C): a cache's
`persist` store (`optimize/persist.py`) holds byte artifacts only. The
serve-path sibling is `optimize/infer_cache.py`.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import kernels
from deeplearning4j_tpu_torch.nn.conf import LayerType, OptimizationAlgorithm
from deeplearning4j_tpu_torch.nn.layers.base import check_ids, ids_checked
from deeplearning4j_tpu_torch.optimize import solver as solver_mod
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves, tree_map
from deeplearning4j_tpu_torch.reliability import faults

log = logging.getLogger("deeplearning4j_tpu_torch")

#: eager calls on a side stream before a capture: the first call of a
#: program loads the kernel libraries, sets their function attributes and
#: makes the cuBLAS workspace and the autograd threads, none of which may
#: happen inside a capture (PyTorch's whole-network capture recipe warms up
#: on a side stream alike)
WARMUP_CALLS = 1


class GraphCaptureError(RuntimeError):
    """A program could not be captured as a CUDA graph."""


def conf_fingerprint(conf) -> str:
    """sha1 of the conf's canonical JSON, truncated: the JAX package's
    fingerprint, so one conf JSON gives one key in both packages."""
    return hashlib.sha1(conf.to_json().encode("utf-8")).hexdigest()[:16]


def arg_signature(*arrays) -> Tuple:
    """(shape, dtype name) per tensor (None stays None): the shape part of
    the cache key, with the JAX package's dtype names ("int32",
    "bfloat16")."""
    return tuple(
        None if a is None
        else (tuple(a.shape), str(a.dtype).replace("torch.", ""))
        for a in arrays)


def check_input(conf, x) -> None:
    """Raise ValueError, on the host, for input the first layer cannot take:
    token ids outside [0, vocab) for an embedding. A captured forward cannot
    check (the check reads back to the host), so the cached entry points
    call this before the ids reach the device program."""
    c = conf.conf(0)
    if c.layer_type == LayerType.EMBEDDING:
        ids = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        check_ids(ids, c.n_in)


class StepCacheStats:
    """Hits, misses, steps and capture seconds per key; `as_dict` has the
    JAX package's keys (the disk and fetch counters stay 0). `solver`
    holds the books of the last run if it was a segmented solver run (else
    None): graphs captured for it (0 on a hit), graph replays, probes per
    iteration and host reads."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.steps = 0
        self.compile_seconds: Dict[Tuple, float] = {}  # key -> seconds
        self.solver: Optional[dict] = None

    @property
    def total_compile_seconds(self) -> float:
        return float(sum(self.compile_seconds.values()))

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "steps": self.steps, "entries": len(self.compile_seconds),
                "compile_seconds": round(self.total_compile_seconds, 3),
                "disk_hits": 0, "disk_write_seconds": 0.0,
                "deserialize_seconds": 0.0, "io_errors": 0,
                "fetch_hits": 0, "fetch_corrupt": 0}

    def __repr__(self):
        return f"StepCacheStats({self.as_dict()})"


class GraphPool:
    """The memory pool that one network's graphs are captured into, and the
    lock under which they are captured and replayed. Graphs that share a
    pool reuse each other's freed memory, so no two of them may run at
    once; and a replay overwrites the static outputs of the last one, so
    callers read them under the lock. `reserved_bytes` sums what the
    captures added to the device's reserved memory."""

    def __init__(self):
        self.lock = threading.RLock()
        self.reserved_bytes = 0
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def renew(self) -> None:
        """Capture into a new pool from here on. A capture that fails can
        leave the allocator recording into its pool, which refuses a second
        capture; graphs already captured keep the pool they were made in."""
        self._handle = None


class TensorSpec(NamedTuple):
    """A tensor's shape, dtype and device: an audit record's leaf, the JAX
    package's `ShapeDtypeStruct`. `value` keeps a host copy of a small
    integer input (ids, positions, lengths, page tables, keys), whose
    values a program indexes with; a float's value does not matter to an
    audit and is not kept."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    value: Optional[torch.Tensor] = None

    #: the largest integer input whose values a record keeps
    KEEP_NUMEL = 1 << 16

    @staticmethod
    def of(t, keep_value: bool = False):
        """The spec of a tensor (with its value where `keep_value` and it
        is a small integer tensor); any other leaf stays as it is."""
        if not isinstance(t, torch.Tensor):
            return t
        value = None
        if (keep_value and not t.is_floating_point()
                and t.numel() <= TensorSpec.KEEP_NUMEL):
            value = t.detach().to("cpu", copy=True)
        return TensorSpec(tuple(t.shape), t.dtype, t.device, value)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def make(self) -> torch.Tensor:
        """A fresh tensor of this spec: the kept value, else zeros."""
        if self.value is not None:
            return self.value.to(self.device, copy=True)
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


def _data_ptrs(params) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in tree_leaves(params))


class _Eager:
    """A program on the CPU: the function itself, run on every call."""

    def __init__(self, fn: Callable, write: Optional[Callable]):
        self.fn, self.write = fn, write

    def stale(self, params) -> bool:
        return False

    def run(self, params, inputs, read, stats):
        stats.solver = None  # the books of segmented runs only
        with ids_checked():
            out = self.fn(params, *inputs)
            if self.write is not None:
                out = self.write(params, out)
        return read(out)


class _EagerSegments:
    """A segmented program run uncaptured: a new run over the call's own
    params and inputs, its segments called directly."""

    def __init__(self, make: Callable):
        self.make = make

    def stale(self, params) -> bool:
        return False

    def run(self, params, inputs, read, stats):
        with ids_checked():
            run = self.make(params, inputs)
            scores = run.drive(lambda name: run.segments[name]())
            run.segments["write"]()
        stats.solver = _solver_books(run, 0, replayed=False)
        return scores


def _solver_books(run, captured: int, replayed: bool) -> dict:
    """The books of a segmented run: graphs captured for it, graph replays
    (init, a probe each, a step an iteration, the write), iterations,
    probes per iteration and host reads."""
    probes = run.books["probes"]
    return {"graphs_captured": captured,
            "graph_replays": (2 + len(probes) + sum(probes)) if replayed
            else 0,
            "iterations_run": len(probes), "probes": list(probes),
            "host_reads": run.books["reads"]}


class _Graph:
    """A captured program: the graph, its static inputs and outputs, the
    params' addresses it reads, and the kernel launches of one replay."""

    def __init__(self, pool: GraphPool, fn: Callable,
                 write: Optional[Callable], params, inputs):
        device = inputs[0].device
        self.pool = pool
        self.ptrs = _data_ptrs(params)
        # static inputs made outside any inference_mode, so that later
        # calls may copy into them whatever mode they run in
        with torch.inference_mode(False):
            self.inputs = tuple(a.clone() for a in inputs)
        with pool.lock:
            start = kernels.launch_snapshot()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with ids_checked(), torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    fn(params, *self.inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            before = kernels.launch_snapshot()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with ids_checked(), torch.cuda.graph(
                        self.graph, pool=pool.handle(), stream=side):
                    out = fn(params, *self.inputs)
                    if write is not None:
                        out = write(params, out)
            except Exception as e:
                pool.renew()
                raise GraphCaptureError(
                    f"CUDA-graph capture failed: {e!r}") from e
            finally:
                after = kernels.launch_snapshot()
                # the warm-up and capture launched nothing on the device
                # that a caller asked for: take them back
                kernels.count_launches({k: start[k] - after[k]
                                        for k in after})
            self.outputs = out
            self.launches = {k: after[k] - before[k] for k in after}
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
            pool.reserved_bytes += self.pool_bytes

    def stale(self, params) -> bool:
        return _data_ptrs(params) != self.ptrs

    def run(self, params, inputs, read, stats):
        stats.solver = None  # the books of segmented runs only
        with self.pool.lock:
            for static, a in zip(self.inputs, inputs):
                static.copy_(a)
            self.graph.replay()
            kernels.count_launches(self.launches)
            return read(self.outputs)


class _GraphSegments:
    """A segmented program captured: one run over static inputs and the
    network's params (by address), each segment one graph, replayed in the
    order the run's host loop asks for them."""

    #: segments warmed up (in this order) before the captures; "write"
    #: changes the params, and is made of copies that need no warm-up
    WARM = ("init", "start", "halve", "finish")

    def __init__(self, pool: GraphPool, make: Callable, params, inputs):
        device = inputs[0].device
        self.pool = pool
        self.ptrs = _data_ptrs(params)
        with torch.inference_mode(False):
            self.inputs = tuple(a.clone() for a in inputs)
        with pool.lock:
            # the run's state is allocated on the caller's stream, outside
            # any capture, so that its addresses stay put
            self.solve = make(params, self.inputs)
            start = kernels.launch_snapshot()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with ids_checked(), torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    for name in self.WARM:
                        self.solve.segments[name]()
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            self.graphs, self.outputs, self.launches = {}, {}, {}
            try:
                for name, fn in self.solve.segments.items():
                    before = kernels.launch_snapshot()
                    graph = torch.cuda.CUDAGraph()
                    with ids_checked(), torch.cuda.graph(
                            graph, pool=pool.handle(), stream=side):
                        self.outputs[name] = fn()
                    after = kernels.launch_snapshot()
                    self.graphs[name] = graph
                    self.launches[name] = {k: after[k] - before[k]
                                           for k in after}
            except Exception as e:
                pool.renew()
                raise GraphCaptureError(
                    f"CUDA-graph capture failed: {e!r}") from e
            finally:
                after = kernels.launch_snapshot()
                kernels.count_launches({k: start[k] - after[k]
                                        for k in after})
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
            pool.reserved_bytes += self.pool_bytes
        self.fresh = True

    def stale(self, params) -> bool:
        return _data_ptrs(params) != self.ptrs

    def _replay(self, name):
        self.graphs[name].replay()
        kernels.count_launches(self.launches[name])
        return self.outputs[name]

    def run(self, params, inputs, read, stats):
        with self.pool.lock:
            for static, a in zip(self.inputs, inputs):
                static.copy_(a)
            scores = self.solve.drive(self._replay)
            self._replay("write")
        stats.solver = _solver_books(
            self.solve, len(self.graphs) if self.fresh else 0, replayed=True)
        self.fresh = False
        return scores


class Segmented:
    """What a segmented program's `build` returns: `make(params, inputs)`
    gives a run with `segments` (name -> function of no arguments; "write"
    puts the result into params in place), `drive(call)` (the host loop,
    returning what the program returns) and `books`."""

    def __init__(self, make: Callable):
        self.make = make


class CompiledProgramCache:
    """Keyed captured programs, grow-on-demand row buckets and the books:
    the machinery `TrainStepCache` and the serve-path `InferCache` share.
    pool: the `GraphPool` the graphs are captured into (a network gives
    both of its caches one). buckets: a fixed set of allowed batch-row
    buckets (None: they grow on demand from the batch sizes seen; a fixed
    set never grows, and a larger batch runs unpadded). persist: a
    `PersistentProgramStore` (`set_persist`). `capture` False runs every
    program uncaptured, on any device."""

    #: label used in miss logs so train and infer captures are told apart
    kind = "program-cache"
    capture = True

    def __init__(self, pool: Optional[GraphPool] = None,
                 buckets: Optional[Tuple[int, ...]] = None, persist=None):
        self._programs: Dict[Tuple, object] = {}
        self._fingerprints: Dict[int, str] = {}  # id(conf) memo
        self._buckets: List[int] = sorted(buckets) if buckets else []
        self._fixed_buckets = buckets is not None
        self.pool = pool if pool is not None else GraphPool()
        self.stats = StepCacheStats()
        # the serving dispatcher and the caller's thread reach one cache:
        # lookup, bucket growth, capture and the books change under it
        self._lock = threading.RLock()
        # the persistent byte store (`optimize/persist.py`), or None
        self._persist = persist
        # one audit record a key (`audit_records`)
        self._audit_records: Dict[Tuple, dict] = {}

    def set_persist(self, store) -> None:
        """Attach a `PersistentProgramStore` (None detaches it). It holds
        byte artifacts; the graphs stay in memory."""
        with self._lock:
            self._persist = store

    @property
    def persist(self):
        return self._persist

    # -- bucket policy ------------------------------------------------------
    def bucket_rows(self, n: int) -> int:
        """Smallest known bucket >= n; otherwise n becomes a new bucket
        (a fixed set never grows: an oversize batch runs unpadded as its
        own bucket, logged). A tuned `infer.bucket_ladder`
        (optimize/tunables.py) pre-seeds the grow-on-demand list; the
        registry default is the empty ladder, which leaves the list as it
        was."""
        from deeplearning4j_tpu_torch.optimize import tunables

        with self._lock:
            if not self._fixed_buckets:
                for b in tunables.resolve("infer.bucket_ladder"):
                    if int(b) not in self._buckets:
                        self._buckets.append(int(b))
                        self._buckets.sort()
            for b in self._buckets:
                if b >= n:
                    return b
            if self._fixed_buckets and self._buckets:
                log.info("%s: batch of %d rows exceeds the fixed buckets "
                         "%s; running unpadded", self.kind, n, self._buckets)
            else:
                self._buckets.append(n)
                self._buckets.sort()
            return n

    @property
    def buckets(self) -> Tuple[int, ...]:
        return tuple(self._buckets)

    # -- programs -----------------------------------------------------------
    def _keyed_conf(self, conf):
        """The conf as the key sees it (the infer cache leaves out what only
        the backward reads)."""
        return conf

    def _fingerprint(self, conf) -> str:
        with self._lock:
            fp = self._fingerprints.get(id(conf))
            if fp is None:
                fp = conf_fingerprint(self._keyed_conf(conf))
                self._fingerprints[id(conf)] = fp
            return fp

    def _audit_scope(self, key: Tuple) -> dict:
        """The record fields that say where a program runs: `mesh` (its
        ranks run collectives), `plan` (the `ShardPlan`, or None) and
        `layout` (the model axis's split leaves, or None)."""
        return {"mesh": False, "plan": None, "layout": None}

    def audit_records(self) -> List[dict]:
        """One record a program key, as the JAX package's caches keep:
        {key, kind, build, write, abstract, in_place, mesh, plan, layout}.
        `abstract` is the (params, *inputs) tree of the first call with
        `TensorSpec` leaves (shape, dtype, device); `in_place` says the
        program writes its result into the params (or the decode state) in
        place, the port's counterpart of donation.
        `analysis.program_audit.audit_cache` runs each `build()` once on
        fresh tensors of those specs."""
        with self._lock:
            return list(self._audit_records.values())

    def _run(self, key: Tuple, build: Callable[[], Callable], params,
             inputs: Tuple[torch.Tensor, ...], read: Callable,
             write: Optional[Callable] = None, compile_only: bool = False):
        """`read` of the program for `key` applied to (params, *inputs),
        and to `write(params, outputs)` where the program writes its result
        into params: on a CUDA device the replay of its graph (captured on
        a miss), on the CPU the program run eagerly. With `compile_only`
        the program is captured (warm-up calls included) and nothing else
        runs: params are untouched and None is returned."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is None or prog.stale(params):
                # armed 'compile' faults fire here: every new program
                # (train or infer) is made at this one place
                faults.fire("compile", kind=self.kind, key=repr(key))
                self.stats.misses += 1
                t0 = time.perf_counter()
                fn = build()
                self._audit_records[key] = dict(
                    key=key, kind=self.kind, build=build, write=write,
                    abstract=(tree_map(TensorSpec.of, params),)
                    + tuple(TensorSpec.of(a, keep_value=True)
                            for a in inputs),
                    in_place=(write is not None
                              or isinstance(fn, Segmented)),
                    **self._audit_scope(key))
                graph = inputs[0].is_cuda and self.capture
                if isinstance(fn, Segmented):
                    prog = (_GraphSegments(self.pool, fn.make, params,
                                           inputs)
                            if graph else _EagerSegments(fn.make))
                elif graph:
                    prog = _Graph(self.pool, fn, write, params, inputs)
                else:
                    prog = _Eager(fn, write)
                dt = time.perf_counter() - t0
                self.stats.compile_seconds[key] = (
                    self.stats.compile_seconds.get(key, 0.0) + dt)
                log.info("%s miss: captured %s in %.2fs (entry %d)",
                         self.kind, key, dt, len(self._programs) + 1)
                self._programs[key] = prog
            else:
                self.stats.hits += 1
            if compile_only:
                return None
            self.stats.steps += 1
        return prog.run(params, inputs, read, self.stats)

    def program_memory(self) -> List[dict]:
        """One row a program (an audit record): {key, entry,
        per_device_argument_bytes, replicated_argument_bytes,
        memory_analysis}, the JAX package's keys. The per-device figure is
        the bytes of the arguments this rank's program reads (under a
        model axis its shards of the split leaves, `parallel/tensor.py`
        SPLITS); the replicated figure counts each split leaf whole, as a
        plan without the model axis would hold it. `memory_analysis` is
        what the port can state of the program itself:
        {"graph_pool_bytes"}, the device memory its capture added to the
        graph pool, for a captured program, else None."""
        with self._lock:
            recs = list(self._audit_records.values())
            programs = dict(self._programs)
        rows = []
        for rec in recs:
            per_dev, whole = _argument_bytes(rec)
            prog = programs.get(rec["key"])
            pool_bytes = getattr(prog, "pool_bytes", None)
            rows.append({"key": rec["key"],
                         "entry": rec["key"][0] if rec["key"] else None,
                         "per_device_argument_bytes": per_dev,
                         "replicated_argument_bytes": whole,
                         "memory_analysis": (
                             None if pool_bytes is None
                             else {"graph_pool_bytes": int(pool_bytes)})})
        return rows

    def clear(self) -> None:
        """Forget every program, its audit record and the books (a fixed
        bucket set stays, grown buckets go). The captured graphs are
        dropped and the memory their captures added to the pool is given
        back to the device; later captures go into a new pool."""
        with self._lock:
            graphs = [p for p in self._programs.values()
                      if isinstance(p, (_Graph, _GraphSegments))]
            self._programs.clear()
            self._audit_records.clear()
            self._buckets = (sorted(self._buckets) if self._fixed_buckets
                             else [])
            self.stats = StepCacheStats()
            if graphs:
                with self.pool.lock:
                    self.pool.reserved_bytes -= sum(g.pool_bytes
                                                    for g in graphs)
                    self.pool.renew()
                del graphs
                torch.cuda.empty_cache()

    def drop_graphs(self) -> None:
        """Forget every captured graph (its memory returns to the pool): the
        params they read are no longer the network's. Books and buckets
        stay; the next call of each key captures anew (a miss)."""
        with self._lock:
            self._programs = {k: p for k, p in self._programs.items()
                              if not isinstance(p, (_Graph,
                                                    _GraphSegments))}

    def __len__(self):
        return len(self._programs)

    # -- padding ------------------------------------------------------------
    @staticmethod
    def pad_batch(x: torch.Tensor, y: torch.Tensor, bucket: int):
        """Zero-pad (x, y) up to `bucket` feature rows and build the
        per-label-row weight vector (pad rows weigh 0). Label rows may be a
        multiple of feature rows (B*T for sequence models)."""
        b = x.shape[0]
        ratio = max(1, y.shape[0] // max(1, b))
        pad = bucket - b
        w = torch.cat([torch.ones(b * ratio, device=x.device),
                       torch.zeros(pad * ratio, device=x.device)])
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            y = torch.cat([y, y.new_zeros((pad * ratio,)
                                          + tuple(y.shape[1:]))])
        return x, y, w


def _argument_bytes(rec) -> Tuple[int, int]:
    """(this rank's, whole) bytes of an audit record's arguments: a param
    leaf the record's `layout` splits over the plan's model axis counts
    `model_size` times in the whole; an int8 leaf's per-column scale too
    where the split is over its columns."""
    params, *inputs = rec["abstract"]
    layout = rec.get("layout") or {}
    size = int(getattr(rec.get("plan"), "model_size", 1) or 1)
    per_dev = sum(t.nbytes for t in _spec_leaves(rec["abstract"]))
    whole = per_dev
    if size > 1 and isinstance(params, (tuple, list)):
        for i, layer in enumerate(params):
            if not isinstance(layer, dict):
                continue
            for name, leaf in layer.items():
                split = layout.get((i, name))
                if split is None:
                    continue
                if isinstance(leaf, dict):
                    q = leaf["q"]
                    split_specs = [q] + ([leaf["scale"]]
                                         if split.dim == len(q.shape) - 1
                                         else [])
                else:
                    split_specs = [leaf]
                whole += (size - 1) * sum(t.nbytes for t in
                                          _spec_leaves(split_specs))
    return per_dev, whole


def _spec_leaves(tree) -> List[TensorSpec]:
    """The `TensorSpec` leaves of a record's tree (a spec is itself a
    tuple, so `tree_leaves` would walk into it)."""
    if isinstance(tree, TensorSpec):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _spec_leaves(x)]
    if isinstance(tree, dict):
        return [t for k in tree for t in _spec_leaves(tree[k])]
    return []


def _write_params(params, out):
    """Inside the train program: copy the new params into the network's
    own tensors (a graph reads and writes them by address), and hand on the
    scores."""
    new, scores = out
    for p, n in zip(tree_leaves(params), tree_leaves(new)):
        p.copy_(n)
    return scores


class TrainStepCache(CompiledProgramCache):
    """The training entry points over `CompiledProgramCache`: one captured
    solver run per (conf, algorithm, bucket), and per (layer, layer conf,
    algorithm, input shape) for pretraining."""

    kind = "step-cache"

    def finetune(self, conf, params, x, y, key=None,
                 compile_only: bool = False):
        """One cached supervised solver run (`MultiLayerNetwork.finetune`):
        checks the ids, pads (x, y) to the bucket, fetches or captures the
        program for (conf, algo, shapes) and runs it on `key` (an int64
        [2] tensor on x's device, or None where nothing is drawn). The
        params tree, the BatchNorm EMA included, is updated in place;
        returns the per-iteration scores as a numpy float32 array. With
        `compile_only` (warm-up) the program is captured without a step:
        params are untouched and None is returned."""
        out_conf = conf.conf(conf.n_layers - 1)
        if _is_hf(out_conf):
            solver_mod.check_jvp(conf, x.is_cuda)
        check_input(conf, x)
        bucket = self.bucket_rows(int(x.shape[0]))
        xp, yp, w = self.pad_batch(x, y, bucket)
        inputs = (xp, yp, w) if key is None else (xp, yp, w, key)
        cache_key = ("finetune", self._fingerprint(conf),
                     str(out_conf.optimization_algo),
                     arg_signature(*inputs))
        return self._run(cache_key, lambda: _finetune_program(conf), params,
                         inputs, read=_read_scores, write=_write_params,
                         compile_only=compile_only)

    def pretrain(self, layer_conf, layer_idx: int, impl, layer_params, x,
                 key=None):
        """One cached layer-wise pretraining solver run
        (`MultiLayerNetwork.pretrain_layer`): the layer's solver on its
        unsupervised objective over `x`, the layer's params (a dict)
        updated in place; returns the per-iteration scores (numpy
        float32). Pretraining objectives take no row weights, so batches
        are not bucketed: each input shape has its own program, keyed by
        the layer index as in the JAX package."""
        inputs = (x,) if key is None else (x, key)
        cache_key = ("pretrain", layer_idx, self._fingerprint(layer_conf),
                     str(layer_conf.optimization_algo), arg_signature(x))
        return self._run(cache_key,
                         lambda: _pretrain_program(layer_conf, impl),
                         layer_params, inputs, read=_read_scores,
                         write=_write_params)


def _read_scores(s) -> np.ndarray:
    """Scores as the host sees them: a segmented run's are numpy already."""
    return s if isinstance(s, np.ndarray) else s.cpu().numpy()


def _is_hf(conf) -> bool:
    return (OptimizationAlgorithm(str(conf.optimization_algo))
            == OptimizationAlgorithm.HESSIAN_FREE)


def _line_searched(conf) -> bool:
    return OptimizationAlgorithm(str(conf.optimization_algo)) in (
        OptimizationAlgorithm.GRADIENT_DESCENT,
        OptimizationAlgorithm.CONJUGATE_GRADIENT,
        OptimizationAlgorithm.LBFGS)


def _solver_program(solver_conf, objective_of: Callable,
                    finalize: Callable) -> Callable:
    """The program of one solver run: `objective_of(*inputs) -> (Objective,
    key)`, the configured solver, then `finalize(new params, aux) -> new
    params` (the BatchNorm EMA). Stepped descent and Hessian-free are one
    function (one graph); a line-searched solver is `Segmented`, whose
    "write" segment puts the result into params in place."""
    if _line_searched(solver_conf):
        def make(params, inputs):
            objective, key = objective_of(*inputs)
            run = solver_mod.LineSearchRun(objective, solver_conf,
                                           solver_conf.optimization_algo)
            run.setup(params, key)

            def write():
                _write_params(params, (finalize(run.unravel(run.flat),
                                                run.aux), None))

            run.segments["write"] = write
            return run

        return Segmented(make)
    solve = (solver_mod._hessian_free if _is_hf(solver_conf)
             else solver_mod.sgd_device)

    def program(params, *inputs):
        objective, key = objective_of(*inputs)
        new, scores, aux = solve(objective, params, solver_conf, key)
        return finalize(new, aux), scores

    return program


def _finetune_program(conf) -> Callable:
    """The (uncaptured) finetune step over explicit batch args: the
    configured solver over the row-weighted loss, then, for a conf with
    BatchNorm, the EMA advanced from the moments of the last live
    iteration's forward (`update_bn_ema_from_stats`), as the JAX package
    folds it into its program. Hessian-free's Gauss-Newton product threads
    the row weights through the loss of the outputs
    (`solver.weighted_predict_loss`), so pad rows carry zero curvature.

    The updater's host constants of the iteration (Adam's bias corrections,
    scheduled momentum, the AdaGrad reset: `optimize/updater.py`) are baked
    into the capture as constants of each unrolled iteration. That is right
    only because every `finetune` restarts the updater at iteration 0, as
    the JAX package's solver does, and the graph unrolls all
    `num_iterations` iterations. The data-parallel trainer's updater
    persists, and its steps (`DPStepCache`) take them as a tensor input
    (`updater.iteration_constants`)."""
    # local import: nn.multilayer imports this module at top level
    from deeplearning4j_tpu_torch.nd.losses import get_rowwise
    from deeplearning4j_tpu_torch.nn.multilayer import (
        has_batchnorm, make_finetune_loss, network_output,
        update_bn_ema_from_stats)

    out_conf = conf.conf(conf.n_layers - 1)
    collect_bn = has_batchnorm(conf)
    loss_fn = make_finetune_loss(conf, collect_bn=collect_bn)
    hf = _is_hf(out_conf)

    def objective_of(x, y, w, key=None):
        objective = solver_mod.from_loss_with_aux(
            lambda p, k: loss_fn(p, x, y, w, k))
        if hf:
            objective = objective._replace(
                gnvp=solver_mod.weighted_predict_loss(
                    lambda p, k: network_output(conf, p, x),
                    get_rowwise(out_conf.loss_function), y, w).gnvp)
        return objective, key

    def finalize(new, aux):
        return update_bn_ema_from_stats(conf, new, aux) if collect_bn else new

    return _solver_program(out_conf, objective_of, finalize)


def pretrain_objective(layer_conf, impl, x) -> "solver_mod.Objective":
    """A pretrainable layer's objective on its input x: its own gradient
    (CD-k for an RBM, autograd for an autoencoder) and score, and its loss
    where it has one (the autoencoder's, for Hessian-free)."""
    loss = getattr(impl, "pretrain_loss", None)
    return solver_mod.Objective(
        grad_and_score=lambda p, k=None: impl.pretrain_grad_and_score(
            p, layer_conf, x, k),
        score=lambda p, k=None: impl.pretrain_score(p, layer_conf, x, k),
        loss=(None if loss is None
              else lambda p, k=None: loss(p, layer_conf, x, k)))


def _pretrain_program(layer_conf, impl) -> Callable:
    """The (uncaptured) layer-pretraining step over explicit x (and the
    layer's key)."""

    def objective_of(x, key=None):
        return pretrain_objective(layer_conf, impl, x), key

    return _solver_program(layer_conf, objective_of, lambda new, aux: new)


class DPStepCache(CompiledProgramCache):
    """The data-parallel trainer's captured steps: one program per
    (variant key, conf, input shapes), over the trainer's flat state
    buffers (params, and the updater's two moments), which the program's
    `write` updates in place. Books as `TrainStepCache`'s; the graphs
    go into the trainer's own memory pool. A tensor-parallel plan's step
    is keyed as the JAX package keys it, ("plan_step",
    plan.sharding_tag(), masked, zero1), and its collectives over the
    model and batch groups run inside its graph (NCCL makes a group's
    communicator at its first collective, so the trainer runs one eager
    collective on each group before any capture)."""

    kind = "dp-step-cache"

    def _audit_scope(self, key):
        """A trainer's step runs its collectives over the mesh's ranks."""
        return {"mesh": True, "plan": None, "layout": None}

    def step(self, variant: Tuple, conf, build: Callable, bufs,
             inputs: Tuple[torch.Tensor, ...], write: Callable,
             compile_only: bool = False):
        """Run (or capture, on a miss) the program of `variant` for
        `conf` on `inputs`: `build()` gives the function of (bufs,
        *inputs) that computes a step, `write(bufs, out)` puts it into the
        buffers and returns the score, a tensor on the device."""
        key = variant + (self._fingerprint(conf), arg_signature(*inputs))
        return self._run(key, build, bufs, inputs, read=_read_score,
                         write=write, compile_only=compile_only)


def _read_score(s: torch.Tensor) -> torch.Tensor:
    """A step's score as the caller keeps it: a copy on the device, since
    the next replay overwrites the graph's static output."""
    return s.detach().clone()

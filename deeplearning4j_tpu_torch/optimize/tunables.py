"""Central registry of performance tunables + the TunedTable override layer.

The port's counterpart of `deeplearning4j_tpu/optimize/tunables.py`, with
its names, subsystems, defaults, docs and semantics. Every tunable constant
of a hot path declares itself here: name, owning subsystem, default value
(exactly the constant the call site used to hard-code), legal search space,
and an analytic cost hint tied to the flops/bytes model in
`optimize/profiling.py`. Call sites resolve through :func:`resolve`, which
consults the process-wide installed :class:`TunedTable` first and falls back
to the registry default, so with no table installed every captured program,
cache key and stored artifact is what it was without the registry.

Tuned tables are produced by `optimize/tune.py` (the `cli tune`
subcommand), keyed per (conf fingerprint, device kind), and persisted in
the shared store through `store_bytes`/`load_bytes` beside the int8
artifact and the prefix entries: replicas and future sessions inherit them
at `set_compile_cache` time with ``fresh_tunes == 0``. The device kind is
`persist.platform_info()["device_kind"]` (the card's name, e.g. "NVIDIA
H100 80GB HBM3"); a table tuned for another kind is never consulted, and a
corrupt artifact checksum-evicts in the store and the caller re-tunes.

Where the port differs: the two attention tunables name the H100 kernels'
tiles, not the TPU's. `attention.block_fwd`'s space is the (block_q,
block_k) tiles the flash forward's bodies are built with (`nd/kernels.
fwd_tiles`: bf16 128 x {128, 64}, f32 64 x {32, 64}), and
`attention.block_bwd`'s the backward's one tile a body (`nd/kernels.
bwd_tile`); None, the default of both, is the body's current tile. The JAX
package's `ATTENTION_BLOCK_TABLE` (TPU v5 lite rows) is not carried over.

This module imports only the stdlib and `reliability.faults` (cost hints
lazy-import profiling) so it is safe to import from the kernel layer.
"""
from __future__ import annotations

import json
import logging
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

log = logging.getLogger("deeplearning4j_tpu_torch")

#: bump when the serialized table layout changes — old artifacts are then
#: simply never looked up (new key), not mis-parsed
SCHEMA_VERSION = 1


class Tunable(NamedTuple):
    """One registered tunable: its identity, default, and search space."""
    name: str          # dotted id, e.g. "batcher.target_rows"
    subsystem: str     # owning subsystem, for docs/reporting
    default: Any       # value call sites get with no table installed
    space: Tuple       # legal candidates (grid of values or of ladders)
    cost_hint: Optional[Callable]  # (value, **ctx) -> relative cost, or None
    doc: str


def _attention_cost(value, seq: int = 1024, head_dim: int = 64, **_):
    """Analytic bytes moved by the flash kernel at (bq, bk) — the pruning
    signal: candidates >= 2x the incumbent's traffic are never compiled."""
    from deeplearning4j_tpu_torch.optimize.profiling import (
        attention_block_bytes)
    bq, bk = value
    return attention_block_bytes(seq, head_dim, bq, bk)


REGISTRY: Dict[str, Tunable] = {}


def _register(name, subsystem, default, space, cost_hint, doc):
    REGISTRY[name] = Tunable(name, subsystem, default, tuple(space),
                             cost_hint, doc)


_register(
    "attention.block_fwd", "nd/kernels", None,
    ((128, 128), (128, 64), (64, 32), (64, 64)),
    _attention_cost,
    "Forward flash-attention (block_q, block_k); None -> the body's "
    "default tile (bf16 128x128; f32 64x64 at head dims up to 64, else "
    "64x32). A tile must be one its body is built with "
    "(nd/kernels.fwd_tiles). Qualified per '{seq}x{head_dim}'.")
_register(
    "attention.block_bwd", "nd/kernels", None,
    ((64, 128), (32, 64), (16, 64)),
    _attention_cost,
    "Backward flash-attention dK/dV (block_q, block_k); None -> the "
    "body's one tile (bf16 64x128; f32 32x64 at head dims up to 64, else "
    "16x64: nd/kernels.bwd_tile), the only one each is built with. "
    "Qualified per '{seq}x{head_dim}'.")
_register(
    "infer.bucket_ladder", "optimize/infer_cache", (),
    ((8, 64, 256), (8, 32, 128, 512), (16, 64, 256, 1024)),
    None,
    "Row buckets pre-seeded into the infer cache's grow-on-demand list; "
    "() keeps pure grow-on-demand (today's behavior).")
_register(
    "batcher.target_rows", "serving/batcher", 256,
    (64, 128, 256, 512, 1024),
    None,
    "MicroBatcher coalescing target when no infer-cache bucket exists "
    "yet (was DEFAULT_TARGET_ROWS).")
_register(
    "batcher.max_delay_ms", "serving/batcher", 3.0,
    (0.5, 1.0, 2.0, 3.0, 5.0, 8.0),
    None,
    "MicroBatcher flush deadline: how long a partial batch waits for "
    "co-riders before dispatch.")
_register(
    "decode.slots", "serving/batcher", 4,
    (1, 2, 4, 8, 16),
    None,
    "ContinuousBatcher decode-table width (concurrent generation "
    "streams per step).")
_register(
    "decode.page_size", "serving/batcher", 0,
    (0, 8, 16, 32),
    None,
    "KV-cache page size in tokens; 0 = contiguous [slots, max_seq] "
    "table (today's default).")
_register(
    "decode.steps_per_dispatch", "serving/batcher", 1,
    (1, 2, 4, 8, 16),
    None,
    "Fused decode block size K: tokens generated per host dispatch "
    "(lax.scan over the decode step). 1 = one program per token "
    "(today's default); >1 amortizes the host loop over K tokens.")
_register(
    "data.prefetch_depth", "datasets/iterator", 2,
    (1, 2, 4, 8),
    None,
    "PrefetchIterator buffer depth (batches staged ahead of the "
    "training step).")


def decode_k_ladder(k_max: int) -> Tuple[int, ...]:
    """Ascending block sizes the adaptive-K decode loop may dispatch for
    a ceiling of `k_max`: every power of two below it, plus `k_max`
    itself.  Warmup compiles exactly this ladder, so a warmed batcher
    ramping 1 -> 2 -> 4 -> ... -> k_max never fresh-compiles."""
    k_max = max(1, int(k_max))
    ladder = []
    v = 1
    while v < k_max:
        ladder.append(v)
        v *= 2
    ladder.append(k_max)
    return tuple(ladder)


class TunedTable:
    """A set of tuned overrides for one (conf fingerprint, device kind).

    ``entries`` maps ``"tunable.name"`` or ``"tunable.name@qualifier"``
    (e.g. ``"attention.block_fwd@1024x64"``) to the winning value.  Only
    names present in :data:`REGISTRY` are ever resolved; unknown entries
    are carried but inert, so newer tables degrade gracefully on older
    code.
    """

    def __init__(self, entries: Optional[Dict[str, Any]] = None,
                 device_kind: str = "", fingerprint: str = "",
                 meta: Optional[dict] = None):
        self.entries = dict(entries or {})
        self.device_kind = device_kind
        self.fingerprint = fingerprint
        self.meta = dict(meta or {})

    # -- serialization ------------------------------------------------------
    def to_bytes(self) -> bytes:
        payload = {
            "schema": SCHEMA_VERSION,
            "device_kind": self.device_kind,
            "fingerprint": self.fingerprint,
            "entries": {k: v for k, v in sorted(self.entries.items())},
            "meta": self.meta,
        }
        return json.dumps(payload, sort_keys=True).encode("utf-8")

    @classmethod
    def from_bytes(cls, blob: bytes) -> "TunedTable":
        payload = json.loads(blob.decode("utf-8"))
        if payload.get("schema") != SCHEMA_VERSION:
            raise ValueError("tuned-table schema %r != %d"
                             % (payload.get("schema"), SCHEMA_VERSION))
        entries = {k: _tupled(v) for k, v in payload["entries"].items()}
        return cls(entries, payload.get("device_kind", ""),
                   payload.get("fingerprint", ""), payload.get("meta"))


def _tupled(v):
    """JSON round-trips tuples as lists; tuned values are tuples."""
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


# -- process-wide active table ----------------------------------------------

_LOCK = threading.Lock()
_ACTIVE: Optional[TunedTable] = None
_SOURCE: str = ""
_FRESH_TUNES = 0
_LOAD_WARNED = False


def default(name: str):
    """The registry default for ``name`` (KeyError on unknown names)."""
    return REGISTRY[name].default


def resolve(name: str, qualifier: Optional[str] = None):
    """The effective value of a tunable: installed-table override
    (qualified entry first, then bare) falling back to the registry
    default.  No table or no entry ⇒ exactly the registry default, so
    call sites behave byte-identically to the pre-registry code."""
    tun = REGISTRY[name]
    with _LOCK:
        table = _ACTIVE
    if table is not None:
        if qualifier is not None:
            hit = table.entries.get("%s@%s" % (name, qualifier))
            if hit is not None:
                return hit
        hit = table.entries.get(name)
        if hit is not None:
            return hit
    return tun.default


def install(table: TunedTable, source: str = "manual") -> None:
    """Make ``table`` the process-wide override layer."""
    global _ACTIVE, _SOURCE
    with _LOCK:
        _ACTIVE = table
        _SOURCE = source


def active() -> Optional[TunedTable]:
    with _LOCK:
        return _ACTIVE


def clear() -> None:
    """Drop the installed table and reset counters (tests, detach)."""
    global _ACTIVE, _SOURCE, _FRESH_TUNES, _LOAD_WARNED
    with _LOCK:
        _ACTIVE = None
        _SOURCE = ""
        _FRESH_TUNES = 0
        _LOAD_WARNED = False


def note_fresh(n: int = 1) -> None:
    """Count tunables whose value was freshly searched (not inherited) in
    this process — warm inherit shows ``fresh_tunes == 0``."""
    global _FRESH_TUNES
    with _LOCK:
        _FRESH_TUNES += int(n)


def status() -> dict:
    """The observability block surfaced in warmup/serve/tune JSON,
    ``/v1/stats``, and the Prometheus families."""
    with _LOCK:
        table, source, fresh = _ACTIVE, _SOURCE, _FRESH_TUNES
    return {
        "tuned_tables": 0 if table is None else 1,
        "fresh_tunes": fresh,
        "entries": 0 if table is None else len(table.entries),
        "device_kind": "" if table is None else table.device_kind,
        "source": source,
    }


# -- persistence (disk compile cache payload path) ---------------------------

def table_key(fingerprint: str, device_kind: str) -> Tuple:
    """Disk-cache key for a tuned table — keyed like any other artifact
    (the store folds its platform fingerprint into the filename; device
    kind rides in the key too so a forged store dir still can't cross
    kinds)."""
    return ("tuned", fingerprint, device_kind, SCHEMA_VERSION)


def save_table(store, table: TunedTable) -> None:
    """Persist via the store's opaque-payload path (checksummed; corrupt
    artifacts evict on read and the caller re-tunes)."""
    store.store_bytes(table_key(table.fingerprint, table.device_kind),
                      table.to_bytes())


def load_table(store, fingerprint: str,
               device_kind: str) -> Optional[TunedTable]:
    """Load a tuned table, degrading to None (registry defaults) on any
    failure with one warning — serving never blocks on tuning."""
    global _LOAD_WARNED
    from deeplearning4j_tpu_torch.reliability import faults
    try:
        faults.fire("tune.load")
        blob = store.load_bytes(table_key(fingerprint, device_kind))
        if blob is None:
            return None
        table = TunedTable.from_bytes(blob)
        if table.device_kind != device_kind:
            raise ValueError("tuned table is for device kind %r, not %r"
                             % (table.device_kind, device_kind))
        return table
    except Exception as e:  # noqa: BLE001 - degrade, never block serving
        with _LOCK:
            warned, _LOAD_WARNED = _LOAD_WARNED, True
        if not warned:
            log.warning("tuned-table load failed (%s: %s); using registry "
                        "defaults", type(e).__name__, e)
        return None


def load_and_install(store, fingerprint: str) -> Optional[TunedTable]:
    """The `set_compile_cache` hook: consult the store for a table tuned
    for *this* device kind and install it if found."""
    kind = store.platform.get("device_kind", "none")
    table = load_table(store, fingerprint, kind)
    if table is not None:
        install(table, source="disk")
    return table

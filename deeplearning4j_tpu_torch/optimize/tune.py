"""Search-based autotuning over the captured-program space.

The port's counterpart of `deeplearning4j_tpu/optimize/tune.py`, with its
flow: for each tunable group, enumerate the registry's declared search
space, prune candidates whose analytic cost (the flops/bytes model in
`optimize/profiling.py`) is >= 2x the incumbent's *before* running
anything, then measure the survivors as real programs through the network's
caches -- warm call outside the timed region (on the card, the capture),
min-of-rounds with an injectable clock. Winners beat the incumbent by a
margin (default 2%) or the default stands, so a tuned table is never
slower than stock within the measurement's noise.

The groups:
  attention  the flash forward at each tile its body is built with
             (`nd/kernels.fwd_tiles`) picks `attention.block_fwd` per
             "{seq}x{head_dim}"; the backward kernels (delta, dK/dV, dQ)
             are measured at their one tile, so `attention.block_bwd`'s
             default stands. The inputs are [8, seq, n_heads, head_dim] in
             the conf's compute dtype (the JAX package measures [1, seq, 2,
             head_dim]; on 132 SMs that is at most 8 blocks, too few to
             judge a tile: ROADMAP.md queue C), and a run is ten launches
             and one synchronize, so that the host's launch cost does not
             decide between tiles.
  serve      `net.output` through the infer cache at each row target picks
             `batcher.target_rows`; the ladder up to the winner becomes
             `infer.bucket_ladder`.
  decode     `InferCache.decode` at each slot width picks `decode.slots`,
             `decode_multi` at each K picks `decode.steps_per_dispatch`, on
             the cache's own states (role "tune"), so that a run replays
             one captured graph.

The winning :class:`~deeplearning4j_tpu_torch.optimize.tunables.TunedTable`
is keyed per (conf fingerprint, device kind) and persisted in the store's
byte payloads, so replicas and future sessions inherit it at
`set_compile_cache` time with ``fresh_tunes == 0``.

Fault points: ``tune.measure`` (per candidate measurement -- a failure,
a CUDA out-of-memory during a capture included, skips the candidate,
counted, and the search completes; the cache stays usable for the next
candidate) and ``tune.load`` (table read -- a failure degrades to registry
defaults with one warning; serving never blocks on tuning).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize import tunables
from deeplearning4j_tpu_torch.optimize.step_cache import conf_fingerprint
from deeplearning4j_tpu_torch.reliability import faults

#: candidates whose analytic cost is >= this multiple of the incumbent's
#: are never run (TVM's "don't measure the obviously bad" pruning)
PRUNE_RATIO = 2.0

#: a challenger must beat the incumbent by this fraction or the default
#: stands -- guarantees tuned >= default within noise (ties keep defaults)
MIN_GAIN = 0.02

#: the attention group's batch, and the launches a timed run makes
ATTENTION_BATCH = 8
ATTENTION_LAUNCHES = 10


class _Search:
    """Bookkeeping shared by every group: measured/pruned/failed counts
    plus the winning entries."""

    def __init__(self, rounds: int, clock):
        self.rounds = max(1, int(rounds))
        self.clock = clock
        self.entries = {}
        self.groups = {}
        self.candidates_measured = 0
        self.candidates_pruned = 0
        self.measure_failures = 0

    def measure(self, step) -> Optional[float]:
        """Min-of-rounds seconds for `step()`, or None when the
        measurement faulted (candidate skipped, search continues)."""
        try:
            faults.fire("tune.measure")
            step()  # warm: capture + first dispatch outside the timed region
            best = None
            for _ in range(self.rounds):
                t0 = self.clock()
                step()
                dt = self.clock() - t0
                best = dt if best is None or dt < best else best
            self.candidates_measured += 1
            return best
        except Exception:  # noqa: BLE001 -- one bad candidate never ends a search
            self.measure_failures += 1
            if torch.cuda.is_available():
                # an out-of-memory candidate leaves its blocks cached
                torch.cuda.empty_cache()
            return None

    def pick(self, group, key, candidates, default_value, run,
             throughput=None):
        """Measure `run(c)` for each candidate; record the winner under
        `key` iff it beats the default by MIN_GAIN.  `candidates` must
        include the default (the incumbent baseline).  `throughput(c)`
        converts each candidate's time to a rows/s-style figure for the
        report (higher is better); without it, lower seconds win."""
        timings = {}
        for cand in candidates:
            t = self.measure(lambda c=cand: run(c))
            if t is None:
                continue
            timings[cand] = t
        report = {"candidates": {repr(c): t for c, t in timings.items()},
                  "default": default_value, "winner": default_value}
        self.groups.setdefault(group, {})[key or group] = report
        if not timings:
            return default_value

        def score(c):
            # higher is better
            return throughput(c) / timings[c] if throughput \
                else 1.0 / timings[c]

        base = score(default_value) if default_value in timings else None
        winner = max(timings, key=score)
        if base is None or score(winner) > base * (1.0 + MIN_GAIN):
            report["winner"] = winner
            if winner != default_value:
                self.entries[key] = winner
        return report["winner"]


def _prune(search, tun, candidates, incumbent, **ctx):
    """Drop candidates whose analytic cost hint is >= PRUNE_RATIO x the
    incumbent's (never run); groups without hints keep everything."""
    if tun.cost_hint is None or incumbent is None:
        return list(candidates)
    base = tun.cost_hint(incumbent, **ctx)
    kept = []
    for c in candidates:
        if c != incumbent and tun.cost_hint(c, **ctx) >= PRUNE_RATIO * base:
            search.candidates_pruned += 1
        else:
            kept.append(c)
    return kept


def _host(t) -> np.ndarray:
    """A result read back to the host (the end of a timed run)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _attention_shapes(conf):
    """(seq, head_dim, n_heads, compute dtype) of the conf's attention
    layers, each once."""
    from deeplearning4j_tpu_torch.nn.conf import LayerType
    from deeplearning4j_tpu_torch.nn.layers.base import compute_dtype

    seq = max([int(c.max_seq_len) for c in conf.confs
               if getattr(c, "max_seq_len", 0)] or [0])
    shapes = []
    for c in conf.confs:
        if c.layer_type == LayerType.ATTENTION and seq > 0:
            heads = max(1, int(c.n_heads))
            shape = (seq, int(c.n_in) // heads, heads, compute_dtype(c))
            if shape not in shapes:
                shapes.append(shape)
    return shapes


def _tune_attention(net, search, rng):
    """Per-(seq, head_dim) flash tile sweep: the forward at each tile its
    body is built with, the backward at its one tile.

    Measured through the kernel wrappers (on the CPU their plain version,
    the same for every tile, so candidates tie and the defaults stand --
    the table only moves on the card, where tiles genuinely differ)."""
    from deeplearning4j_tpu_torch.nd import kernels

    dev = net.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for seq, hd, heads, dtype in _attention_shapes(net.conf):
        shape = (ATTENTION_BATCH, seq, heads, hd)
        q, k, v, do = (torch.from_numpy(np.asarray(
            rng.standard_normal(shape), np.float32)).to(dev, dtype)
            for _ in range(4))
        qualifier = "%dx%d" % (seq, hd)
        for name, bwd in (("attention.block_fwd", False),
                          ("attention.block_bwd", True)):
            tun = tunables.REGISTRY[name]
            if bwd:
                incumbent = kernels.bwd_tile(dtype, hd)
                cands = [incumbent]
            else:
                tiles = kernels.fwd_tiles(dtype, hd)
                incumbent = tiles[0]
                cands = [c for c in tun.space if c in tiles]
                if incumbent not in cands:
                    cands.insert(0, incumbent)
            cands = _prune(search, tun, cands, incumbent,
                           seq=seq, head_dim=hd)

            def run(c, bwd=bwd):
                if bwd:
                    o, lse = kernels.flash_attn_fwd(q, k, v, True,
                                                    with_lse=True)
                    for _ in range(ATTENTION_LAUNCHES):
                        delta = kernels.flash_bwd_delta(o, do)
                        kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True)
                        kernels.flash_bwd_dq(q, k, v, do, lse, delta, True)
                else:
                    for _ in range(ATTENTION_LAUNCHES):
                        kernels.flash_attn_fwd(q, k, v, True, tile=c)
                sync()

            search.pick("attention", "%s@%s" % (name, qualifier), cands,
                        incumbent, run)
            tunables.note_fresh()


def _release_graphs(net) -> None:
    """Drop the network's captured graphs and give their memory back: a
    measured candidate's graph is not run again, and on the card the serve
    group's pool holds tens of GB at its largest candidates (the next
    capture would find the card full)."""
    net.infer_cache.drop_graphs()
    if net.device.type == "cuda":
        torch.cuda.empty_cache()


def _serve_input(conf, rows, rng):
    """A well-formed serve batch for the conf's input layer: int token
    ids [rows, seq] for embedding-first models (seq capped by the
    learned positional table), float features [rows, n_in] otherwise."""
    from deeplearning4j_tpu_torch.nn.conf import LayerType
    c0 = conf.confs[0]
    if c0.layer_type == LayerType.EMBEDDING:
        seq = int(getattr(c0, "max_seq_len", 0)) or 16
        return rng.integers(0, int(c0.n_in),
                            size=(rows, seq)).astype(np.int32)
    return np.asarray(rng.standard_normal((rows, int(c0.n_in))), np.float32)


def _tune_serve(net, search, rng):
    """Row-count sweep through the infer cache: rows/s at each candidate
    target picks `batcher.target_rows`; the measured ladder up to the
    winner becomes `infer.bucket_ladder` so warm processes pre-seed the
    same buckets.  Ascending order so each candidate captures at its own
    exact bucket (`bucket_rows` grows on demand). Each candidate's graph is
    dropped before the next one captures; the report's `pool_bytes` holds
    what each capture added to the graph pool (0 on the CPU, which captures
    nothing)."""
    tun = tunables.REGISTRY["batcher.target_rows"]
    incumbent = tun.default
    cands = sorted(set(tun.space) | {incumbent})
    pool = net.infer_cache.pool
    pool_bytes = {}
    last = [None]

    def run(rows):
        if last[0] != rows:
            _release_graphs(net)
            last[0] = rows
        before = pool.reserved_bytes
        _host(net.output(_serve_input(net.conf, rows, rng)))
        pool_bytes.setdefault(repr(rows), pool.reserved_bytes - before)

    winner = search.pick("serve", "batcher.target_rows", cands, incumbent,
                         run, throughput=lambda rows: float(rows))
    _release_graphs(net)
    tunables.note_fresh()
    search.groups["serve"]["batcher.target_rows"]["pool_bytes"] = pool_bytes
    measured = search.groups["serve"]["batcher.target_rows"]["candidates"]
    ladder = tuple(c for c in cands if repr(c) in measured and c <= winner)
    if winner != incumbent and ladder:
        search.entries["infer.bucket_ladder"] = ladder


def _decode_inputs(slots):
    return (np.zeros((slots,), np.int32), np.zeros((slots,), np.int32),
            np.zeros((slots, 2), np.uint32), np.zeros((slots,), np.float32))


def _tune_decode(net, search, max_seq):
    """Slot-width sweep through the captured decode step: tokens/s at
    each table width picks `decode.slots` (every live slot yields one
    token per step, so wider tables win until the step time grows
    faster than the width)."""
    from deeplearning4j_tpu_torch.nn import decode as decode_mod
    try:
        decode_mod.check_generative(net.conf)
    except Exception:  # noqa: BLE001 -- non-generative conf: nothing to tune
        return
    bound = decode_mod.positional_bound(net.conf)
    if bound:
        max_seq = min(int(max_seq), int(bound))
    if net.params is None:
        net.init()
    ic = net.infer_cache
    tun = tunables.REGISTRY["decode.slots"]
    incumbent = tun.default
    cands = sorted(set(tun.space) | {incumbent})

    def run(slots):
        state = ic.decode_state(net.conf, slots, max_seq, net.device, "tune")
        tok, pos, keys, temps = _decode_inputs(slots)
        # the state is written in place: its next call decodes on
        for _ in range(4):
            tok, keys, state = ic.decode(net.conf, net.params, state,
                                         tok, pos, keys, temps)
            pos = pos + 1
        _host(tok)

    search.pick("decode", "decode.slots", cands, incumbent, run,
                throughput=lambda slots: float(slots))
    tunables.note_fresh()
    _tune_decode_steps(net, search, max_seq)


def _tune_decode_steps(net, search, max_seq):
    """K sweep through the captured decode block: tokens/s at each
    steps-per-dispatch picks `decode.steps_per_dispatch` (each dispatch
    advances every slot K tokens and costs ONE host round-trip, so
    bigger K wins until per-step device time dominates the amortised
    host overhead)."""
    ic = net.infer_cache
    slots = 2
    tun = tunables.REGISTRY["decode.steps_per_dispatch"]
    incumbent = tun.default
    cands = sorted(k for k in set(tun.space) | {incumbent}
                   if k <= max_seq)

    def run(k):
        state = ic.decode_state(net.conf, slots, max_seq, net.device, "tune")
        tok, pos, keys, temps = _decode_inputs(slots)
        steps = 0
        while steps + k <= max_seq:
            rem = np.full((slots,), k, np.int32)
            _, tok, keys, state = ic.decode_multi(
                net.conf, net.params, state, tok, pos, keys, temps,
                rem, k)
            pos = pos + k
            steps += k
        _host(tok)

    # every candidate decodes (about) the same token count, so the
    # tokens-per-run numerator is the actual work done, not K itself
    search.pick("decode", "decode.steps_per_dispatch", cands, incumbent,
                run, throughput=lambda k: float(slots * (max_seq // k) * k))
    tunables.note_fresh()


def tune_model(net, groups: Sequence[str] = ("attention", "serve",
                                             "decode"),
               rounds: int = 3, seed: int = 0, clock=time.perf_counter,
               max_seq: int = 64) -> dict:
    """Search the registry's config space for `net` and return the report
    (winning entries + counters).  Deterministic under a fixed seed and
    an injected clock: candidate order is fixed and data comes from the
    seeded rng."""
    t0 = clock()
    if net.params is None:
        net.init()
    rng = np.random.default_rng(seed)
    search = _Search(rounds, clock)
    if "attention" in groups:
        _tune_attention(net, search, rng)
    if "serve" in groups:
        _tune_serve(net, search, rng)
    if "decode" in groups:
        _tune_decode(net, search, max_seq)
    fp = conf_fingerprint(net.conf)
    report = {
        "fingerprint": fp,
        "groups": search.groups,
        "entries": {k: v for k, v in sorted(search.entries.items())},
        "candidates_measured": search.candidates_measured,
        "candidates_pruned": search.candidates_pruned,
        "measure_failures": search.measure_failures,
        "rounds": search.rounds,
        "seed": int(seed),
        "tune_seconds": clock() - t0,
    }
    return report


def tune_and_store(net, store=None, force: bool = False, **kw) -> dict:
    """The `cli tune` entry point: inherit an existing valid table from
    the store (``fresh_tunes == 0``) unless `force`, else search, persist
    the winners, and install the table process-wide.  Returns the report
    with the `tuning` status block attached."""
    fp = conf_fingerprint(net.conf)
    kind = store.platform.get("device_kind", "none") if store is not None \
        else _device_kind(net)
    if store is not None and not force:
        existing = tunables.load_table(store, fp, kind)
        if existing is not None:
            tunables.install(existing, source="disk")
            return {
                "fingerprint": fp,
                "device_kind": kind,
                "entries": dict(existing.entries),
                "candidates_measured": 0,
                "candidates_pruned": 0,
                "measure_failures": 0,
                "tune_seconds": 0.0,
                "tuning": tunables.status(),
            }
    report = tune_model(net, **kw)
    table = tunables.TunedTable(report["entries"], device_kind=kind,
                                fingerprint=fp,
                                meta={"rounds": report["rounds"],
                                      "seed": report["seed"]})
    if store is not None:
        tunables.save_table(store, table)
    tunables.install(table, source="fresh")
    report["device_kind"] = kind
    report["tuning"] = tunables.status()
    return report


def _device_kind(net=None) -> str:
    from deeplearning4j_tpu_torch.optimize.persist import platform_info
    return platform_info(None if net is None else net.device).get(
        "device_kind", "none")

"""Prometheus text-format exporter for the serving fabric (stdlib-only).

The TPU datacenter argument (Jouppi et al., 2017) is operational: the
fleet runs latency-bounded inference, which means the fleet is operated
off dashboards — queue depths, batch-size distributions, per-class
latency histograms, breaker state.  This module turns the gateway's
existing stats dicts (`MicroBatcher.stats()` → `ModelServer.stats()`,
`Router.stats()`) into the Prometheus text exposition format 0.0.4 so a
stock Prometheus scrape of `/metrics` on any replica or on the router
needs no sidecar and no client library.

Format contract (tested in tests/test_serving_fabric.py):
  - every family gets exactly one `# HELP` and one `# TYPE` line;
  - histogram families export cumulative `_bucket{le="..."}` series
    ending in `le="+Inf"`, plus `_sum` and `_count`;
  - counters only ever move up across scrapes (the underlying stats are
    process-lifetime totals, never windowed);
  - label values are escaped per the spec (backslash, quote, newline).

The port's own copy of `deeplearning4j_tpu/serving/metrics.py`: the same
families and the same text for the same stats dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: what /metrics responses declare (the version IS part of the contract)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: `le` bounds for the coalesced batch-size histogram (rows per device
#: call); powers of two bracket every default bucket the infer cache
#: grows, +Inf catches anything larger
BATCH_ROWS_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

#: THE declared registry of every metric family this module may emit:
#: name -> (type, own label keys).  The repo linter
#: (`analysis/repo_lint.py`, rule `prom-family`) enforces both
#: directions against the emission calls below — an emitted family
#: missing here, a declared family never emitted, a type mismatch, or
#: an emission whose label keys stray outside the declared set all fail
#: the build.  Two keys are implicit and allowed everywhere: `replica`
#: (the router stamps it when re-exporting a replica's families) and
#: `le` on histogram buckets.  Dashboards and alert rules key on these
#: exact (name, labels) pairs: editing a declared set is a breaking
#: change to every consumer, which is the point of declaring it.
FAMILIES = {
    "dl4j_serving_ready": ("gauge", ()),
    "dl4j_serving_inflight": ("gauge", ()),
    "dl4j_serving_precision_policy_info": ("gauge", ("policy",)),
    "dl4j_serving_policy_rows_total": ("counter", ("policy",)),
    "dl4j_serving_precision_accuracy_delta": ("gauge",
                                              ("policy", "metric")),
    "dl4j_serving_queue_depth": ("gauge", ("priority",)),
    "dl4j_serving_requests_total": ("counter", ("priority",)),
    "dl4j_serving_request_latency_seconds": ("histogram",
                                             ("priority", "policy")),
    "dl4j_serving_batch_rows": ("histogram", ()),
    "dl4j_serving_rows_total": ("counter", ()),
    "dl4j_serving_errors_total": ("counter", ()),
    "dl4j_serving_deadline_misses_total": ("counter", ()),
    "dl4j_serving_degraded_batches_total": ("counter", ()),
    "dl4j_serving_breaker_state": ("gauge", ()),
    "dl4j_serving_breaker_opens_total": ("counter", ()),
    "dl4j_serving_cache_hits_total": ("counter", ("policy",)),
    "dl4j_serving_cache_misses_total": ("counter", ("policy",)),
    "dl4j_serving_cache_disk_hits_total": ("counter", ("policy",)),
    "dl4j_serving_cache_io_errors_total": ("counter", ("policy",)),
    "dl4j_serving_cache_fetch_hits_total": ("counter", ("policy",)),
    "dl4j_serving_cache_fetch_corrupt_total": ("counter", ("policy",)),
    "dl4j_serving_tokens_total": ("counter", ()),
    "dl4j_serving_ttft_seconds": ("histogram", ()),
    "dl4j_serving_decode_slots": ("gauge", ("state",)),
    "dl4j_serving_kv_pages": ("gauge", ("state",)),
    "dl4j_serving_prefix_cache_hits_total": ("counter", ()),
    "dl4j_serving_prefix_cache_misses_total": ("counter", ()),
    "dl4j_serving_accepted_tokens_per_step": ("histogram", ()),
    "dl4j_serving_decode_block_steps": ("histogram", ()),
    "dl4j_serving_decode_host_seconds_total": ("counter", ()),
    "dl4j_router_ready": ("gauge", ()),
    "dl4j_router_inflight": ("gauge", ()),
    "dl4j_router_replicas_healthy": ("gauge", ()),
    "dl4j_router_requests_total": ("counter", ("priority",)),
    "dl4j_router_request_latency_seconds": ("histogram", ("priority",)),
    "dl4j_router_retries_total": ("counter", ()),
    "dl4j_router_unroutable_total": ("counter", ()),
    "dl4j_router_hedges_total": ("counter", ()),
    "dl4j_router_hedge_wins_total": ("counter", ()),
    "dl4j_router_retry_budget_remaining": ("gauge", ()),
    "dl4j_router_retry_budget_exhausted_total": ("counter", ()),
    "dl4j_router_policy_rows_total": ("counter", ("policy",)),
    "dl4j_router_replica_healthy": ("gauge", ("replica",)),
    "dl4j_router_replica_breaker_state": ("gauge", ("replica",)),
    "dl4j_router_replica_stats_age_seconds": ("gauge", ("replica",)),
    "dl4j_router_host_replicas": ("gauge", ("host",)),
    "dl4j_router_host_breaker_opens_total": ("counter", ("host",)),
    "dl4j_tuning_table_info": ("gauge", ("device_kind",)),
    "dl4j_tuning_fresh_tunes_total": ("counter", ()),
    "dl4j_fleet_replicas": ("gauge", ("state",)),
    "dl4j_fleet_restarts_total": ("counter", ()),
    "dl4j_fleet_spawn_failures_total": ("counter", ()),
    "dl4j_fleet_quarantine_remaining_seconds": ("gauge", ("slot",)),
    "dl4j_fleet_partitions_total": ("counter", ()),
    "dl4j_fleet_failovers_total": ("counter", ()),
    "dl4j_agent_up": ("gauge", ("agent",)),
    "dl4j_agent_replicas": ("gauge", ("agent",)),
    "dl4j_agent_partitions_total": ("counter", ("agent",)),
    "dl4j_agent_reconciles_total": ("counter", ("agent",)),
    "dl4j_agent_adopted_total": ("counter", ("agent",)),
    "dl4j_agent_orphans_stopped_total": ("counter", ("agent",)),
    "dl4j_agent_failovers_total": ("counter", ("agent",)),
    "dl4j_autoscaler_decisions_total": ("counter", ("decision",)),
    "dl4j_autoscaler_target_replicas": ("gauge", ()),
}


def escape_label_value(v) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


class PrometheusText:
    """Accumulates metric families and renders one exposition page.

    Families keep insertion order; samples of one family stay together
    under a single HELP/TYPE pair however many labeled series join it.
    """

    def __init__(self):
        # name -> (type, help, [(suffix, labels, value)])
        self._families: Dict[str, Tuple[str, str, List]] = {}
        self._order: List[str] = []

    def _family(self, name: str, mtype: str, help_text: str) -> List:
        fam = self._families.get(name)
        if fam is None:
            fam = (mtype, help_text, [])
            self._families[name] = fam
            self._order.append(name)
        return fam[2]

    def gauge(self, name: str, help_text: str, value,
              labels: Optional[Dict[str, str]] = None) -> None:
        self._family(name, "gauge", help_text).append(("", labels, value))

    def counter(self, name: str, help_text: str, value,
                labels: Optional[Dict[str, str]] = None) -> None:
        """`name` must already end in `_total` (spec convention)."""
        self._family(name, "counter", help_text).append(("", labels, value))

    def histogram(self, name: str, help_text: str, bounds, counts,
                  inf: int, total_sum: float, total_count: int,
                  labels: Optional[Dict[str, str]] = None) -> None:
        """Append one histogram series.  `counts` are per-bucket
        (NON-cumulative) observation counts aligned with `bounds`; the
        cumulative sums the text format wants are computed here."""
        fam = self._family(name, "histogram", help_text)
        cum = 0
        for bound, c in zip(bounds, counts):
            cum += int(c)
            lbl = dict(labels or {})
            lbl["le"] = _fmt_value(bound)
            fam.append(("_bucket", lbl, cum))
        lbl = dict(labels or {})
        lbl["le"] = "+Inf"
        fam.append(("_bucket", lbl, cum + int(inf)))
        fam.append(("_sum", dict(labels or {}), float(total_sum)))
        fam.append(("_count", dict(labels or {}), int(total_count)))

    def render(self) -> str:
        lines: List[str] = []
        for name in self._order:
            mtype, help_text, samples = self._families[name]
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for suffix, labels, value in samples:
                lines.append(
                    f"{name}{suffix}{_fmt_labels(labels)} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"


def _batch_rows_histogram(hist: Dict[str, int]):
    """(counts per BATCH_ROWS_BOUNDS, inf, sum, count) from the exact
    {rows: batches} histogram the batcher keeps."""
    counts = [0] * len(BATCH_ROWS_BOUNDS)
    inf = 0
    total_sum = 0.0
    total_count = 0
    for rows_s, n in hist.items():
        rows, n = int(rows_s), int(n)
        total_sum += rows * n
        total_count += n
        for i, bound in enumerate(BATCH_ROWS_BOUNDS):
            if rows <= bound:
                counts[i] += n
                break
        else:
            inf += n
    return counts, inf, total_sum, total_count


def replica_metrics(stats: dict, page: Optional[PrometheusText] = None,
                    labels: Optional[Dict[str, str]] = None) -> str:
    """Render a `ModelServer.stats()` dict as Prometheus text.

    `labels` (e.g. {"replica": "0"}) are stamped on every series —
    that's how the router re-exports each replica's metrics under one
    scrape without name collisions.  Pass `page` to merge several stats
    dicts into one exposition (again: the router)."""
    own_page = page is None
    p = PrometheusText() if own_page else page
    base = dict(labels or {})

    def lbl(**extra):
        d = dict(base)
        d.update(extra)
        return d or None

    p.gauge("dl4j_serving_ready", "1 once warmed and not draining.",
            1 if stats.get("ready") else 0, lbl())
    p.gauge("dl4j_serving_inflight",
            "HTTP predict handlers currently in flight.",
            stats.get("inflight", 0), lbl())
    # serve-precision policy: an info-style gauge names the active
    # policy, per-policy row counters split throughput, and the
    # accuracy delta measured at set_serve_precision time rides along —
    # all label-compatible with the router's `replica` re-export
    prec = stats.get("precision", {})
    policy = prec.get("policy", "f32")
    p.gauge("dl4j_serving_precision_policy_info",
            "Active serve-precision policy (info-style gauge: the value "
            "is always 1, the policy is the label).",
            1, lbl(policy=policy))
    for pol, rows in sorted(prec.get("rows_by_policy", {}).items()):
        p.counter("dl4j_serving_policy_rows_total",
                  "Feature rows served per precision policy.",
                  rows, lbl(policy=pol))
    delta = (prec.get("report", {}) or {}).get("accuracy_delta") or {}
    for metric in ("top1_delta", "rel_mse"):
        if metric in delta:
            p.gauge("dl4j_serving_precision_accuracy_delta",
                    "Measured accuracy delta vs the f32 reference on the "
                    "held-out batch (by metric).",
                    delta[metric], lbl(policy=policy, metric=metric))
    prios = stats.get("priorities", {})
    for prio, ps in sorted(prios.items()):
        p.gauge("dl4j_serving_queue_depth",
                "Requests coalescing in the gateway queue.",
                ps.get("queue_depth", 0), lbl(priority=prio))
        p.counter("dl4j_serving_requests_total",
                  "Requests completed (answered or failed).",
                  ps.get("requests", 0), lbl(priority=prio))
        h = ps.get("latency_hist_s")
        if h:
            p.histogram("dl4j_serving_request_latency_seconds",
                        "Enqueue-to-answer latency of successful requests.",
                        h["bounds"], h["counts"], h["inf"], h["sum"],
                        h["count"], lbl(priority=prio, policy=policy))
    counts, inf, bsum, bcount = _batch_rows_histogram(
        stats.get("batch_rows_hist", {}))
    p.histogram("dl4j_serving_batch_rows",
                "Coalesced rows per device call.",
                BATCH_ROWS_BOUNDS, counts, inf, bsum, bcount, lbl())
    p.counter("dl4j_serving_rows_total", "Feature rows served.",
              stats.get("rows", 0), lbl())
    p.counter("dl4j_serving_errors_total",
              "Requests answered with an error.",
              stats.get("errors", 0), lbl())
    p.counter("dl4j_serving_deadline_misses_total",
              "Requests evicted past their deadline.",
              stats.get("deadline_misses", 0), lbl())
    p.counter("dl4j_serving_degraded_batches_total",
              "Batches served by the eager (breaker-open) fallback.",
              stats.get("degraded_batches", 0), lbl())
    breaker = stats.get("breaker", {})
    from deeplearning4j_tpu_torch.reliability import CircuitBreaker
    p.gauge("dl4j_serving_breaker_state",
            "Execute-path circuit breaker: 0 closed, 1 open, 2 half-open.",
            CircuitBreaker.STATE_CODES.get(breaker.get("state"), 0), lbl())
    p.counter("dl4j_serving_breaker_opens_total",
              "Times the breaker tripped open.",
              breaker.get("opens", 0), lbl())
    cache = stats.get("cache", {})
    p.counter("dl4j_serving_cache_hits_total",
              "Infer-cache in-memory program hits.",
              cache.get("hits", 0), lbl(policy=policy))
    p.counter("dl4j_serving_cache_misses_total",
              "Infer-cache misses (fresh compiles; 0 on a warmed server).",
              cache.get("misses", 0), lbl(policy=policy))
    p.counter("dl4j_serving_cache_disk_hits_total",
              "Programs restored from the persistent disk cache.",
              cache.get("disk_hits", 0), lbl(policy=policy))
    p.counter("dl4j_serving_cache_io_errors_total",
              "Disk-cache I/O errors downgraded to misses.",
              cache.get("io_errors", 0), lbl(policy=policy))
    p.counter("dl4j_serving_cache_fetch_hits_total",
              "Programs warmed over the cachesync wire from a peer's "
              "compile cache (fetched, validated, never compiled).",
              cache.get("fetch_hits", 0), lbl(policy=policy))
    p.counter("dl4j_serving_cache_fetch_corrupt_total",
              "Remote cache fetches that failed checksum re-validation "
              "on arrival (downgraded to counted misses).",
              cache.get("fetch_corrupt", 0), lbl(policy=policy))
    tuning = stats.get("tuning")
    if tuning:
        # info-style: the value is the installed-table count (0/1), the
        # table's device kind rides as the label; fresh_tunes counts
        # tunables searched in-process (0 on a warm inherit)
        p.gauge("dl4j_tuning_table_info",
                "Tuned tables installed (info-style gauge; the table's "
                "device kind is the label).",
                tuning.get("tuned_tables", 0),
                lbl(device_kind=tuning.get("device_kind") or "none"))
        p.counter("dl4j_tuning_fresh_tunes_total",
                  "Tunables freshly searched in this process (a warm "
                  "process inheriting its table from disk reports 0).",
                  tuning.get("fresh_tunes", 0), lbl())
    gen = stats.get("generation")
    if gen:
        p.counter("dl4j_serving_tokens_total",
                  "Tokens produced by the continuous-batching decode "
                  "loop (prefill's first token included).",
                  gen.get("tokens", 0), lbl())
        h = gen.get("ttft_hist_s")
        if h:
            p.histogram("dl4j_serving_ttft_seconds",
                        "Submit-to-first-token latency of generation "
                        "streams.", h["bounds"], h["counts"], h["inf"],
                        h["sum"], h["count"], lbl())
        slots = gen.get("slots", {})
        p.gauge("dl4j_serving_decode_slots",
                "Decode slot-table occupancy (by state).",
                slots.get("active", 0), lbl(state="active"))
        p.gauge("dl4j_serving_decode_slots",
                "Decode slot-table occupancy (by state).",
                slots.get("free", 0), lbl(state="free"))
        pages = gen.get("kv_pages")
        if pages:
            p.gauge("dl4j_serving_kv_pages",
                    "Paged KV-cache page-pool occupancy (by state).",
                    pages.get("free", 0), lbl(state="free"))
            p.gauge("dl4j_serving_kv_pages",
                    "Paged KV-cache page-pool occupancy (by state).",
                    pages.get("live", 0), lbl(state="live"))
        prefix = gen.get("prefix_cache")
        if prefix:
            p.counter("dl4j_serving_prefix_cache_hits_total",
                      "Stream admissions that reused cached prefill "
                      "state (prefix-cache hits).",
                      prefix.get("hits", 0), lbl())
            p.counter("dl4j_serving_prefix_cache_misses_total",
                      "Stream admissions that ran a cold prefill "
                      "(prefix-cache misses).",
                      prefix.get("misses", 0), lbl())
        spec = gen.get("speculative")
        h = (spec or {}).get("accepted_hist")
        if h and h.get("count"):
            p.histogram("dl4j_serving_accepted_tokens_per_step",
                        "Tokens accepted per speculative verify step "
                        "(draft proposals plus the guaranteed target "
                        "token).", h["bounds"], h["counts"], h["inf"],
                        h["sum"], h["count"], lbl())
        h = gen.get("decode_block_steps")
        if h and h.get("count"):
            p.histogram("dl4j_serving_decode_block_steps",
                        "Decode steps fused per device dispatch (the "
                        "adaptive-K fused decode block; 1 = classic "
                        "step-at-a-time decode).", h["bounds"],
                        h["counts"], h["inf"], h["sum"], h["count"],
                        lbl())
        p.counter("dl4j_serving_decode_host_seconds_total",
                  "Host-side seconds of the decode loop spent outside "
                  "the device-readback wait (dispatch, scheduling, "
                  "token delivery); with wall time this gives the "
                  "host-overhead fraction fused dispatch amortises.",
                  gen.get("decode_host_seconds_total", 0.0), lbl())
    return p.render() if own_page else ""


def router_metrics(stats: dict) -> str:
    """Render a `Router.stats()` dict — the router's own counters plus a
    re-export of every replica's last-known stats under a `replica`
    label — as one Prometheus page."""
    p = PrometheusText()
    p.gauge("dl4j_router_ready", "1 while the router admits traffic.",
            1 if stats.get("ready") else 0)
    p.gauge("dl4j_router_inflight",
            "Proxied requests currently in flight.", stats.get("inflight", 0))
    p.gauge("dl4j_router_replicas_healthy",
            "Replicas currently routable.", stats.get("healthy_replicas", 0))
    for prio, ps in sorted(stats.get("priorities", {}).items()):
        p.counter("dl4j_router_requests_total",
                  "Requests routed (by priority class).",
                  ps.get("requests", 0), {"priority": prio})
        h = ps.get("latency_hist_s")
        if h:
            p.histogram("dl4j_router_request_latency_seconds",
                        "Router-side latency of successfully proxied "
                        "requests.", h["bounds"], h["counts"], h["inf"],
                        h["sum"], h["count"], {"priority": prio})
    p.counter("dl4j_router_retries_total",
              "Requests retried on a sibling replica.",
              stats.get("retries", 0))
    p.counter("dl4j_router_unroutable_total",
              "Requests answered 503: no routable replica.",
              stats.get("unroutable", 0))
    p.counter("dl4j_router_hedges_total",
              "Hedged duplicate attempts fired after the quantile-"
              "tracked delay.", stats.get("hedges", 0))
    p.counter("dl4j_router_hedge_wins_total",
              "Hedged attempts that answered before the primary.",
              stats.get("hedge_wins", 0))
    budget = stats.get("retry_budget", {})
    p.gauge("dl4j_router_retry_budget_remaining",
            "Retry/hedge tokens left in the trailing budget window.",
            budget.get("remaining", 0))
    p.counter("dl4j_router_retry_budget_exhausted_total",
              "Extra attempts denied by the retry budget (the request "
              "degraded to single-attempt).",
              budget.get("exhausted_total", 0))
    for pol, rows in sorted(stats.get("rows_by_policy", {}).items()):
        p.counter("dl4j_router_policy_rows_total",
                  "Fleet-wide feature rows served per precision policy, "
                  "aggregated over replicas.", rows, {"policy": pol})
    from deeplearning4j_tpu_torch.reliability import CircuitBreaker
    for rep in stats.get("replicas", []):
        rl = {"replica": str(rep.get("index"))}
        p.gauge("dl4j_router_replica_healthy",
                "1 while the replica passes /readyz and its breaker "
                "allows traffic.", 1 if rep.get("healthy") else 0, rl)
        p.gauge("dl4j_router_replica_breaker_state",
                "Per-replica routing breaker: 0 closed, 1 open, "
                "2 half-open.",
                CircuitBreaker.STATE_CODES.get(
                    rep.get("breaker", {}).get("state"), 0), rl)
        age = rep.get("last_ok_poll_age_s")
        if age is not None:
            p.gauge("dl4j_router_replica_stats_age_seconds",
                    "Seconds since the replica's stats were last polled "
                    "successfully.", age, rl)
        rep_stats = rep.get("stats")
        # a stale replica's cached stats are history, not state: keep
        # them off the page rather than exporting a dead replica as live
        if rep_stats and not rep.get("stale"):
            replica_metrics(rep_stats, page=p, labels=rl)
    for host, hs in sorted(stats.get("hosts", {}).items()):
        hl = {"host": host}
        p.gauge("dl4j_router_host_replicas",
                "Registered replicas per host (failure domain).",
                hs.get("replicas", 0), hl)
        p.counter("dl4j_router_host_breaker_opens_total",
                  "Routing-breaker trips aggregated per host — a dying "
                  "host is one signal, not N replica signals.",
                  hs.get("breaker_opens", 0), hl)
    fleet = stats.get("fleet")
    if fleet:
        for state, n in sorted(fleet.get("states", {}).items()):
            p.gauge("dl4j_fleet_replicas",
                    "Supervised replica slots by lifecycle state.",
                    n, {"state": state})
        p.counter("dl4j_fleet_restarts_total",
                  "Replica processes respawned after a death.",
                  fleet.get("restarts_total", 0))
        p.counter("dl4j_fleet_spawn_failures_total",
                  "Respawn attempts that failed before the replica "
                  "became ready.", fleet.get("spawn_failures_total", 0))
        p.counter("dl4j_fleet_partitions_total",
                  "Agent leases lost to missed heartbeats (the "
                  "supervisor marked the agent partitioned).",
                  fleet.get("partitions_total", 0))
        p.counter("dl4j_fleet_failovers_total",
                  "Slots failed over to a surviving agent after a "
                  "partition outlived the failover deadline.",
                  fleet.get("failovers_total", 0))
        for slot in fleet.get("slots", []):
            p.gauge("dl4j_fleet_quarantine_remaining_seconds",
                    "Seconds until a quarantined slot's probe respawn "
                    "unlocks (0 for non-quarantined slots).",
                    slot.get("quarantine_remaining_s", 0.0),
                    {"slot": str(slot.get("id"))})
        for ag in fleet.get("agents", []):
            al = {"agent": ag.get("host") or ag.get("url") or ""}
            p.gauge("dl4j_agent_up",
                    "1 while the agent's lease is held (0: partitioned).",
                    1 if ag.get("state") == "leased" else 0, al)
            p.gauge("dl4j_agent_replicas",
                    "Live replicas on the agent per its last good "
                    "snapshot.", ag.get("replicas_live", 0), al)
            p.counter("dl4j_agent_partitions_total",
                      "Times this agent's lease was lost.",
                      ag.get("partitions_total", 0), al)
            p.counter("dl4j_agent_reconciles_total",
                      "Lease re-acquisitions that reconciled agent "
                      "state against supervisor intent.",
                      ag.get("reconciles_total", 0), al)
            p.counter("dl4j_agent_adopted_total",
                      "Still-live replicas adopted back into rotation "
                      "after a partition healed (never respawned).",
                      ag.get("adopted_total", 0), al)
            p.counter("dl4j_agent_orphans_stopped_total",
                      "Live agent children stopped at reconcile because "
                      "no slot intends them anymore.",
                      ag.get("orphans_stopped_total", 0), al)
            p.counter("dl4j_agent_failovers_total",
                      "Slots this agent lost to failover while "
                      "partitioned.", ag.get("failovers_total", 0), al)
    autoscaler = stats.get("autoscaler")
    if autoscaler:
        for decision, n in sorted(autoscaler.get("decisions", {}).items()):
            p.counter("dl4j_autoscaler_decisions_total",
                      "Autoscaler evaluations by decision.",
                      n, {"decision": decision})
        p.gauge("dl4j_autoscaler_target_replicas",
                "Replica count the autoscaler currently wants.",
                autoscaler.get("target_replicas", 0))
    return p.render()


def parse_prometheus_text(text: str):
    """Minimal conformance parser used by tests and doctors: returns
    {metric sample name: {frozen labels: value}} and raises ValueError
    on any line that is not valid exposition format."""
    import re

    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
        r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?)*)\})?"
        r" (-?(?:[0-9.eE+-]+|Inf|NaN))$")
    label_re = re.compile(r"([a-zA-Z_][a-zA-Z0-9_]*)=\"((?:[^\"\\]|\\.)*)\"")
    out: Dict[str, Dict] = {}
    typed = set()
    helped = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            if name in helped:
                raise ValueError(f"line {lineno}: duplicate HELP for {name}")
            helped.add(name)
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE line: {line!r}")
            if parts[2] in typed:
                raise ValueError(
                    f"line {lineno}: duplicate TYPE for {parts[2]}")
            typed.add(parts[2])
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            raise ValueError(f"line {lineno}: unparseable sample: {line!r}")
        name, raw_labels, raw_value = m.groups()
        labels = tuple(sorted(label_re.findall(raw_labels or "")))
        value = float(raw_value.replace("Inf", "inf"))
        series = out.setdefault(name, {})
        if labels in series:
            raise ValueError(f"line {lineno}: duplicate series {line!r}")
        series[labels] = value
    return out

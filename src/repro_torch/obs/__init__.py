"""``repro.obs`` — dependency-free tracing + metrics for every tier.

One :class:`Registry` holds the three metric kinds (mergeable log-bucket
:class:`~repro.obs.metrics.Histogram`, ``Counter``, ``Gauge``), the
bounded span ring, and the correlation context (wave / epoch / session
ids).  The serving stack, engines, planner, and durable tier all talk to
the **process-global registry** through the module-level helpers below —
``obs.span("wal.commit")``, ``obs.histogram("serving.request_nav_ms")``
— so one export covers the whole stack.

Switched by ``REPRO_TRACE`` (default ``0``): when disabled, ``span()``
returns a no-op singleton and the metric accessors return a shared null
metric — no clock reads, no dict churn, zero allocations on every hot
path (the bench gate runs with tracing off and must see no regression).
``configure(enabled=True)`` flips the live registry at runtime (tests,
``examples/quickstart.py``); ``REPRO_STATS_EVERY`` and
``REPRO_TRACE_RING`` tune the serving stats-log cadence and the ring
size (see docs/OBSERVABILITY.md for the contracts and the snapshot
schema).
"""
from __future__ import annotations

import os
import time
from collections import deque

from .metrics import NULL_METRIC, Counter, Gauge, Histogram
from .trace import NULL_SPAN, Span, export_events, load_events, validate_events

#: master switch: "1"/"true"/"on" enable tracing + metric recording
TRACE_ENV = "REPRO_TRACE"
#: span ring capacity (events retained for export); default 65536
RING_ENV = "REPRO_TRACE_RING"
#: serving stats-log cadence in waves; 0 (default) disables the log line
STATS_EVERY_ENV = "REPRO_STATS_EVERY"

_TRUTHY = ("1", "true", "on", "yes")


def _env_enabled() -> bool:
    return os.environ.get(TRACE_ENV, "0").strip().lower() in _TRUTHY


def stats_every() -> int:
    """Resolved ``REPRO_STATS_EVERY`` (0 ⇒ periodic stats log off)."""
    try:
        return max(0, int(os.environ.get(STATS_EVERY_ENV, "0")))
    except ValueError:
        return 0


class Registry:
    """Metrics + trace ring + correlation context, one per process (the
    module-global default) or per test (instantiate directly)."""

    def __init__(self, enabled: bool | None = None,
                 ring_size: int | None = None):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        if ring_size is None:
            ring_size = int(os.environ.get(RING_ENV, str(64 * 1024)))
        self.ring: deque = deque(maxlen=max(16, ring_size))
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.ctx: dict[str, object] = {}
        self.t0 = time.perf_counter()
        self.pid = os.getpid()

    # -- metric accessors (null objects when disabled) ----------------------
    # setdefault is a single atomic dict op, so two worker threads racing
    # to create the same metric get the same object (a stray loser
    # Histogram() is garbage, never a dropped-sample sink)
    def histogram(self, name: str):
        if not self.enabled:
            return NULL_METRIC
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms.setdefault(name, Histogram())
        return h

    def counter(self, name: str):
        if not self.enabled:
            return NULL_METRIC
        c = self.counters.get(name)
        if c is None:
            c = self.counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str):
        if not self.enabled:
            return NULL_METRIC
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges.setdefault(name, Gauge())
        return g

    # -- spans --------------------------------------------------------------
    def span(self, name: str, **tags):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, tags or None)

    def set_context(self, **ids) -> None:
        """Update correlation ids (wave/epoch/session) captured into the
        args of every subsequently recorded span."""
        if self.enabled:
            self.ctx.update(ids)

    # -- export / snapshot --------------------------------------------------
    def export_trace(self, path: str) -> int:
        """Write the ring as Chrome trace-event / Perfetto JSON; returns
        the number of events exported."""
        return export_events(list(self.ring), path)

    def metrics_snapshot(self) -> dict:
        """JSON-able state of every metric (fixed schema; empty dicts
        when disabled — the schema never changes shape)."""
        return {
            "latency_ms": {name: h.summary()
                           for name, h in sorted(self.histograms.items())},
            "counters": {name: c.value
                         for name, c in sorted(self.counters.items())},
            "gauges": {name: g.value
                       for name, g in sorted(self.gauges.items())},
        }

    def reset(self) -> None:
        """Drop all recorded state (metrics, ring, context); keeps the
        enabled flag and the clock origin."""
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()
        self.ring.clear()
        self.ctx.clear()


_registry = Registry()


def registry() -> Registry:
    return _registry


def configure(enabled: bool | None = None,
              ring_size: int | None = None) -> Registry:
    """Replace the global registry (runtime enable/disable for tests and
    examples); returns the new registry."""
    global _registry
    _registry = Registry(enabled=enabled, ring_size=ring_size)
    return _registry


def enabled() -> bool:
    return _registry.enabled


def span(name: str, **tags):
    return _registry.span(name, **tags)


def histogram(name: str):
    return _registry.histogram(name)


def counter(name: str):
    return _registry.counter(name)


def gauge(name: str):
    return _registry.gauge(name)


def set_context(**ids) -> None:
    _registry.set_context(**ids)


def export_trace(path: str) -> int:
    return _registry.export_trace(path)


# ---------------------------------------------------------------------------
# the live stats surface (ServingEngine.stats_snapshot + quickstart)
# ---------------------------------------------------------------------------
#: read-op dedup ratio keys (logical ops served / unique keys executed)
_READ_OPS = ("q1_get", "q2_ls", "q3_navigate", "q4_search", "q4_contains")


def build_snapshot(engine=None, planner=None, extra: dict | None = None) -> dict:
    """Assemble the JSON-able live stats snapshot: engine op accounting,
    planner wave/dedup state, refresh + durable-tier telemetry, and every
    registry metric.  The TOP-LEVEL KEY SET is a stable contract
    (tests/test_obs.py pins it) — new fields nest under existing keys."""
    reg = _registry
    snap: dict = {
        "trace_enabled": reg.enabled,
        "epoch": 0,
        "waves": 0,
        "ops": {},
        "dedup_ratio": {},
        "refresh": {},
        "durable": {},
        "pending": {},
    }
    snap.update(reg.metrics_snapshot())
    if engine is not None:
        sync = getattr(engine, "sync_durable_stats", None)
        if sync is not None:
            sync()
        st = engine.stats
        snap["epoch"] = engine.epoch
        snap["ops"] = {"calls": dict(st.calls), "ops": dict(st.ops),
                       "served": dict(st.served),
                       "max_batch": dict(st.max_batch),
                       "max_served": dict(st.max_served)}
        snap["dedup_ratio"] = {
            op: round(st.served[op] / st.ops[op], 4)
            for op in _READ_OPS
            if st.ops.get(op) and st.served.get(op) is not None}
        snap["refresh"] = {
            "commits": st.calls.get("refresh", 0),
            "rows": st.ops.get("refresh", 0),
            "patch": st.calls.get("refresh_patch", 0),
            "rebuild": st.calls.get("refresh_rebuild", 0),
            "last_kind": getattr(engine, "last_refresh_kind", None),
            "deferred_waves": getattr(engine, "_deferred_waves", 0),
        }
        bloom_neg = st.ops.get("d_bloom_neg", 0)
        hit = st.ops.get("d_cache_hit", 0)
        miss = st.ops.get("d_cache_miss", 0)
        debt = st.ops.get("d_compact_debt", 0)
        snap["durable"] = {
            "bloom_neg": bloom_neg, "cache_hit": hit, "cache_miss": miss,
            "cache_hit_rate": round(hit / (hit + miss), 4) if hit + miss else 0.0,
            "seg_probe": st.ops.get("d_seg_probe", 0),
            # compaction backpressure: outstanding merge bytes (gauge)
            # and whether the serving tier should expect throttled waves
            "compact_debt": debt,
            "backpressure": bool(debt),
            # pipelined group commit: sealed-but-not-durable waves (0/1)
            "commit_pipeline_depth": st.ops.get("d_commit_pipeline_depth", 0),
        }
    if planner is not None:
        snap["waves"] = planner.flushes
        snap["pending"]["planner_ops"] = planner.pending_ops()
        snap["pending"]["planner_writes"] = planner.pending_writes()
    if extra:
        snap.update(extra)
    return snap


def format_snapshot(snap: dict) -> str:
    """Human-readable summary table of a :func:`build_snapshot` dict (the
    quickstart's exit print)."""
    lines = [f"telemetry (trace_enabled={snap['trace_enabled']}, "
             f"epoch={snap['epoch']}, waves={snap['waves']})"]
    lat = snap.get("latency_ms", {})
    if lat:
        lines.append(f"  {'span':32s} {'count':>7s} {'p50ms':>9s} "
                     f"{'p90ms':>9s} {'p99ms':>9s} {'maxms':>9s}")
        for name, s in lat.items():
            lines.append(f"  {name:32s} {s['count']:7d} {s['p50']:9.3f} "
                         f"{s['p90']:9.3f} {s['p99']:9.3f} {s['max']:9.3f}")
    calls = snap.get("ops", {}).get("calls", {})
    if calls:
        ops = snap["ops"]["ops"]
        lines.append("  engine calls: " + "  ".join(
            f"{op}={n}({ops.get(op, 0)} keys)"
            for op, n in sorted(calls.items())))
    if snap.get("dedup_ratio"):
        lines.append("  dedup (served/keys): " + "  ".join(
            f"{op}={r:.2f}" for op, r in sorted(snap["dedup_ratio"].items())))
    dur = snap.get("durable", {})
    if any(dur.get(k) for k in ("bloom_neg", "cache_hit", "cache_miss",
                                "seg_probe")):
        lines.append(f"  durable: bloom_neg={dur['bloom_neg']} "
                     f"cache_hit_rate={dur['cache_hit_rate']:.2f} "
                     f"seg_probe={dur.get('seg_probe', 0)}")
    if dur.get("compact_debt"):
        lines.append(f"  compaction backpressure: "
                     f"debt={dur['compact_debt']}B")
    return "\n".join(lines)


__all__ = ["Registry", "Histogram", "Counter", "Gauge", "Span",
           "NULL_SPAN", "NULL_METRIC",
           "registry", "configure", "enabled", "span", "histogram",
           "counter", "gauge", "set_context", "export_trace",
           "build_snapshot", "format_snapshot", "stats_every",
           "load_events", "validate_events", "export_events",
           "TRACE_ENV", "RING_ENV", "STATS_EVERY_ENV"]

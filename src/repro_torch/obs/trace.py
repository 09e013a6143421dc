"""Wave-scoped spans, the bounded trace ring, and the Perfetto exporter.

A :class:`Span` measures one timed region on the monotonic clock
(``time.perf_counter``) and, at exit, (1) appends one Chrome
trace-event-format ``"ph": "X"`` (complete) event to the registry's
bounded ring buffer and (2) records its duration into the registry
histogram of the same name — so every span is simultaneously a trace
line (open the export in ``chrome://tracing`` / Perfetto) and a latency
sample (read percentiles out of ``stats_snapshot()``).

Correlation: every span captures the registry's current **context ids**
(wave / epoch / session — set by the planner and serving loop at wave
boundaries) into its ``args``, so a WAL commit deep in the storage tier
carries the planner wave that caused it.  Nesting is positional, the
Chrome way: spans on one thread close LIFO (context managers), so any
two events on a ``tid`` are either disjoint or properly contained —
``validate_events`` checks exactly that invariant plus clock
monotonicity, and ``scripts/check_trace.py`` runs it in CI against the
trace the smoke serving wave exports.

When tracing is disabled (``REPRO_TRACE=0``, the default) ``span()``
returns the :data:`NULL_SPAN` singleton: enter/exit are no-ops, nothing
is timed, nothing is allocated.
"""
from __future__ import annotations

import json
import os
import threading
import time

# Chrome trace-event keys — see the Trace Event Format spec (Perfetto
# loads this JSON directly)
_PH_COMPLETE = "X"


class Span:
    """One timed region; use as a context manager.  ``set(**tags)`` adds
    args after entry (e.g. a result kind known only at the end)."""

    __slots__ = ("_reg", "name", "args", "_t0", "dur_ms")

    def __init__(self, reg, name: str, args: dict | None):
        self._reg = reg
        self.name = name
        self.args = args
        self._t0 = 0.0
        self.dur_ms = 0.0

    def set(self, **tags) -> "Span":
        if self.args is None:
            self.args = tags
        else:
            self.args.update(tags)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        self.dur_ms = (t1 - self._t0) * 1e3
        reg = self._reg
        args = dict(reg.ctx)
        if self.args:
            args.update(self.args)
        reg.ring.append({
            "name": self.name,
            "ph": _PH_COMPLETE,
            "ts": (self._t0 - reg.t0) * 1e6,      # µs since registry birth
            "dur": (t1 - self._t0) * 1e6,
            "pid": reg.pid,
            "tid": threading.get_ident(),
            "args": args,
        })
        reg.histogram(self.name).record(self.dur_ms)
        return False


class _NullSpan:
    """The disabled-mode singleton: no clock reads, no ring append, no
    histogram, no allocations."""

    __slots__ = ()
    name = ""
    dur_ms = 0.0

    def set(self, **tags) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


# ---------------------------------------------------------------------------
# export + validation
# ---------------------------------------------------------------------------
def export_events(events: list[dict], path: str) -> int:
    """Write ``events`` as a Chrome trace-event / Perfetto JSON object
    (``{"traceEvents": [...]}``); returns the event count."""
    doc = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(doc["traceEvents"])


def load_events(path: str) -> list[dict]:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace-event document "
                         "(no traceEvents list)")
    return events


def validate_events(events: list[dict],
                    require: tuple[str, ...] = ()) -> list[str]:
    """Structural validity of a span trace; returns problem strings
    (empty ⇒ valid).  Checks:

    * every event is a complete ("X") span with numeric ``ts``/``dur``
      ≥ 0 and a ``tid``;
    * per-``tid`` spans are **well-nested**: sorted by start (ties: the
      longer span opens first — the enclosing context manager entered
      first), every span either starts after the enclosing span ends or
      ends within it (with a float-µs tolerance for clock granularity);
    * per-``tid`` start times are monotone in that sort — a span never
      starts before trace time 0;
    * every name in ``require`` appears at least once (the smoke gate's
      planner-wave → engine-op → device-refresh → WAL-commit coverage).
    """
    problems: list[str] = []
    by_tid: dict[object, list[tuple[float, float, str]]] = {}
    seen: set[str] = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        name = ev.get("name")
        ts, dur = ev.get("ts"), ev.get("dur")
        if ev.get("ph") != _PH_COMPLETE:
            problems.append(f"event {i} ({name}): ph != 'X'")
            continue
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            problems.append(f"event {i} ({name}): non-numeric ts/dur")
            continue
        if ts < 0 or dur < 0:
            problems.append(f"event {i} ({name}): negative ts/dur")
            continue
        seen.add(str(name))
        by_tid.setdefault(ev.get("tid"), []).append(
            (float(ts), float(dur), str(name)))
    eps = 1.5  # µs of tolerance: ring append happens after the clock read
    for tid, spans in by_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list[tuple[float, float, str]] = []
        for ts, dur, name in spans:
            while stack and ts >= stack[-1][0] + stack[-1][1] - eps:
                stack.pop()
            if stack and ts + dur > stack[-1][0] + stack[-1][1] + eps:
                outer = stack[-1]
                problems.append(
                    f"tid {tid}: span {name!r} [{ts:.1f}, {ts + dur:.1f}] "
                    f"overlaps {outer[2]!r} "
                    f"[{outer[0]:.1f}, {outer[0] + outer[1]:.1f}] "
                    "without nesting")
            stack.append((ts, dur, name))
    for name in require:
        if name not in seen:
            problems.append(f"required span {name!r} absent from trace")
    return problems

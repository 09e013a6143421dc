"""Mergeable metrics primitives: log-bucket histograms, counters, gauges.

The histogram is the load-bearing piece (ISSUE 8): every latency number
the system reports — engine per-op percentiles, WAL commit/fsync times,
refresh patch-vs-rebuild durations, the benchmark tables — flows through
ONE implementation with FIXED bucket boundaries, so

* per-shard / per-engine / per-process histograms **merge exactly**:
  ``merge(h(A), h(B)) ≡ h(A ∪ B)`` bucket-for-bucket (property-tested in
  tests/test_obs.py), which is what a sharded or multi-process deployment
  needs to report fleet-wide p99 without shipping raw samples; and
* ``ServingEngine.stats_snapshot()`` and the benchmark tables read
  percentiles out of the same logic — identical samples give identical
  p50/p99 by construction, not by coincidence.

Bucketing: value ``v > 0`` lands in bucket ``floor(log2(v) * SUB)`` with
``SUB = 16`` sub-buckets per octave — ~4.4% relative bucket width, so a
reported percentile is within ~2.2% of the exact sample percentile
(nearest-rank).  Buckets are sparse (dict), value-domain agnostic (the
repo convention is milliseconds for latency histograms), and the exact
``min``/``max``/``sum`` are tracked alongside, so ``max`` (and p100) are
never quantized.  Non-positive values count in a dedicated zero bucket.

Everything here is dependency-free stdlib.  The histogram/counter write
paths take a per-metric lock: spans record from shard-executor, commit-
sequencer, and background-compaction worker threads (ISSUE 10), and an
unlocked ``self.n += 1`` read-modify-write drops increments under that
concurrency.  Gauges stay lock-free — a single reference assignment is
atomic and last-write-wins is their contract anyway.
"""
from __future__ import annotations

import math
import threading
from typing import Iterable

#: sub-buckets per power of two — fixed FOREVER at the format level:
#: changing it would silently break merges between old and new snapshots
SUB = 16
_INV_LOG2 = SUB / math.log(2.0)


def bucket_of(v: float) -> int:
    """Fixed global bucket index for ``v > 0``."""
    return math.floor(math.log(v) * _INV_LOG2)


def bucket_value(idx: int) -> float:
    """Representative (geometric midpoint) value of bucket ``idx``."""
    return 2.0 ** ((idx + 0.5) / SUB)


class Histogram:
    """Sparse log-bucket histogram with exact-merge semantics."""

    __slots__ = ("counts", "n", "total", "vmin", "vmax", "zeros", "_lock")

    def __init__(self, samples: Iterable[float] = ()):
        self.counts: dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zeros = 0
        self._lock = threading.Lock()
        for v in samples:
            self.record(v)

    # -- write path ---------------------------------------------------------
    def record(self, v: float) -> None:
        """O(1), allocation-free (dict slot reuse after first touch)."""
        with self._lock:
            self.n += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if v <= 0.0:
                self.zeros += 1
                return
            b = math.floor(math.log(v) * _INV_LOG2)
            self.counts[b] = self.counts.get(b, 0) + 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into ``self`` (exact: fixed shared boundaries).
        Returns ``self`` for chaining."""
        with self._lock:
            for b, c in other.counts.items():
                self.counts[b] = self.counts.get(b, 0) + c
            self.n += other.n
            self.total += other.total
            self.zeros += other.zeros
            self.vmin = min(self.vmin, other.vmin)
            self.vmax = max(self.vmax, other.vmax)
            return self

    # -- read path ----------------------------------------------------------
    def percentile(self, q: float) -> float:
        """Nearest-rank percentile ``q`` ∈ [0, 100] over the recorded
        distribution; bucket geometric midpoints, exact at the extremes
        (p0 → true min, p100 → true max).  0.0 on an empty histogram."""
        with self._lock:
            if self.n == 0:
                return 0.0
            if q <= 0:
                return self.vmin
            if q >= 100:
                return self.vmax
            rank = max(1, math.ceil(q / 100.0 * self.n))
            if rank <= self.zeros:
                return 0.0
            seen = self.zeros
            for b in sorted(self.counts):
                seen += self.counts[b]
                if seen >= rank:
                    # clamp into the true observed range so a one-bucket
                    # histogram reports its real sample, not the midpoint
                    return min(max(bucket_value(b), self.vmin), self.vmax)
            return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def summary(self) -> dict:
        """JSON-able fixed-schema summary (the snapshot row format)."""
        empty = self.n == 0
        return {
            "count": self.n,
            "mean": round(self.mean, 6),
            "p50": round(self.percentile(50), 6),
            "p90": round(self.percentile(90), 6),
            "p99": round(self.percentile(99), 6),
            "max": 0.0 if empty else round(self.vmax, 6),
            "min": 0.0 if empty else round(self.vmin, 6),
        }


class Counter:
    """Monotone counter (wire format: one int)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class _NullMetric:
    """Shared no-op stand-in handed out by a disabled registry: every
    recording call is a constant-time no-op with ZERO allocations — the
    "telemetry is free when off" half of the ISSUE 8 acceptance."""

    __slots__ = ()

    def record(self, v: float) -> None:
        pass

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass


NULL_METRIC = _NullMetric()

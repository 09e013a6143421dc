"""Three-tier path-keyed cache (paper §V-C).

L1 — in-process, tens of pages: the root index and every dimension node.
     Pre-warmed, never expired during process lifetime, refreshed on
     invalidation events.
L2 — shared tier (the paper's Redis), thousands of pages: full directory
     set + hot entities by ``access_count``.  LRU with TTL so displaced
     pages are reclaimed even without explicit invalidation.
L3 — the persistent PathStore: authoritative, no expiration (staleness is
     handled actively by invalidation + Error Book, not passive expiry).

TPU mapping (DESIGN.md §3): L1 = device-pinned tensor rows of the
tensorstore; L2 = host-RAM shared table; L3 = persistent store.  The
host-side implementation here is the protocol reference; the tensorstore
carries the same L1 contract on device.

Invalidation: subscribes to the ``InvalidationBus``; an event for path p
refreshes every cached entry whose key equals p or has p as a segment
prefix.  Because Theorem 2 rules out advertised-but-missing children in
the underlying store, a racing invalidation costs at most one extra L3
round trip and can never surface a partial write (paper §V-C).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import paths as P
from . import records as R
from .consistency import Invalidation, InvalidationBus
from .store import PathStore


@dataclass
class CacheStats:
    l1_hits: int = 0
    l2_hits: int = 0
    l3_hits: int = 0
    misses: int = 0
    invalidations: int = 0
    evictions: int = 0

    def hit_rate(self) -> float:
        total = self.l1_hits + self.l2_hits + self.l3_hits + self.misses
        return 0.0 if total == 0 else (self.l1_hits + self.l2_hits) / total


class LruTtl:
    """LRU + TTL map (the L2 policy)."""

    def __init__(self, capacity: int, ttl: float,
                 clock: Callable[[], float] = time.time):
        self.capacity = capacity
        self.ttl = ttl
        self.clock = clock
        self._d: "OrderedDict[str, tuple[float, bytes]]" = OrderedDict()
        self.evictions = 0

    def get(self, key: str) -> Optional[bytes]:
        item = self._d.get(key)
        if item is None:
            return None
        ts, val = item
        if self.clock() - ts > self.ttl:
            del self._d[key]
            return None
        self._d.move_to_end(key)
        return val

    def put(self, key: str, val: bytes) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = (self.clock(), val)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def drop(self, key: str) -> None:
        self._d.pop(key, None)

    def keys(self) -> list[str]:
        return list(self._d.keys())

    def __len__(self) -> int:
        return len(self._d)


class TieredCache:
    """L1/L2/L3 read path with path-keyed invalidation."""

    def __init__(self, store: PathStore, bus: InvalidationBus | None = None,
                 l1_capacity: int = 64, l2_capacity: int = 4096,
                 l2_ttl: float = 3600.0,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.l1: dict[str, bytes] = {}
        self.l1_capacity = l1_capacity
        self.l2 = LruTtl(l2_capacity, l2_ttl, clock=clock)
        self.stats = CacheStats()
        if bus is not None:
            bus.subscribe(self._on_invalidate)

    # ------------------------------------------------------------------
    def prewarm(self) -> int:
        """Load the root and every dimension node into L1 (paper: pre-warmed
        at process start)."""
        n = 0
        root = self.store.get(P.ROOT)
        if root is None:
            return 0
        self.l1[P.ROOT] = R.encode(root)
        n += 1
        if isinstance(root, R.DirRecord):
            for seg in root.children():
                dp = P.child(P.ROOT, seg)
                rec = self.store.get(dp)
                if rec is not None and len(self.l1) < self.l1_capacity:
                    self.l1[dp] = R.encode(rec)
                    n += 1
        return n

    def get(self, path: str) -> Optional[R.Record]:
        path = P.normalize(path, depth_budget=self.store.depth_budget)
        raw = self.l1.get(path)
        if raw is not None:
            self.stats.l1_hits += 1
            return R.decode(raw)
        raw = self.l2.get(path)
        if raw is not None:
            self.stats.l2_hits += 1
            return R.decode(raw)
        rec = self.store.get(path)
        if rec is None:
            self.stats.misses += 1
            return None
        self.stats.l3_hits += 1
        self._promote(path, rec)
        return rec

    def ls(self, path: str) -> Optional[tuple[R.DirRecord, list[str]]]:
        rec = self.get(path)
        if rec is None or not isinstance(rec, R.DirRecord):
            return None
        return rec, [P.child(path, s) for s in rec.children()]

    # -- split read path for the batched engine (core/engine.py) ----------
    def peek(self, path: str) -> Optional[R.Record]:
        """L1/L2 probe only — never touches L3.  A ``None`` means "not
        cached": the caller routes the miss through its batched engine and
        reports the result back via ``admit``."""
        path = P.normalize(path, depth_budget=self.store.depth_budget)
        raw = self.l1.get(path)
        if raw is not None:
            self.stats.l1_hits += 1
            return R.decode(raw)
        raw = self.l2.get(path)
        if raw is not None:
            self.stats.l2_hits += 1
            return R.decode(raw)
        return None

    def admit(self, path: str, rec: Optional[R.Record]) -> None:
        """Account + promote an engine-resolved read (the L3 half of
        ``get`` when the fetch itself ran through a batched engine)."""
        path = P.normalize(path, depth_budget=self.store.depth_budget)
        if rec is None:
            self.stats.misses += 1
            return
        self.stats.l3_hits += 1
        self._promote(path, rec)

    def _promote(self, path: str, rec: R.Record) -> None:
        raw = R.encode(rec)
        # L1 is reserved for the root + dimension working set
        if P.depth(path) <= 1 and len(self.l1) < self.l1_capacity:
            self.l1[path] = raw
        else:
            self.l2.put(path, raw)

    # ------------------------------------------------------------------
    def _on_invalidate(self, ev: Invalidation) -> None:
        """Refresh any L1/L2 entry whose key equals, or is an ancestor of,
        the affected path; and drop descendants of the affected path."""
        self.stats.invalidations += 1
        affected = ev.path
        # exact + descendant keys in L1
        for key in list(self.l1.keys()):
            if key == affected or P.is_prefix(affected, key) or P.is_prefix(key, affected):
                rec = self.store.get(key)
                if rec is None:
                    del self.l1[key]
                else:
                    self.l1[key] = R.encode(rec)
        for key in self.l2.keys():
            if key == affected or P.is_prefix(affected, key):
                self.l2.drop(key)

    def memory_footprint(self) -> dict[str, int]:
        """Resident bytes per in-memory tier — the 'bounded footprint'
        claim of §V-C is asserted against these in tests."""
        l1 = sum(len(v) for v in self.l1.values())
        l2 = sum(len(v) for _, (_, v) in self.l2._d.items())
        return {"l1_bytes": l1, "l2_bytes": l2,
                "l1_entries": len(self.l1), "l2_entries": len(self.l2)}

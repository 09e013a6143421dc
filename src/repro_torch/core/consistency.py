"""Consistency protocol (paper §IV-C).

* **Write protocol (parent-after-child)** — to admit node v at π(v)=/d/e:
  (1) ``PUT(π(v), c(v))`` writes the child record;
  (2) ``UPDATE(π(parent(v)))`` appends the segment to the parent's child list.
  If (2) fails, v is an unadvertised orphan — harmless.

* **Read protocol (skip-on-miss)** — ``LS(π)`` fetches the directory record,
  then GETs each advertised child; a child GET that returns ⊥ is silently
  dropped.  Theorem 2: under write-order + monotonic cross-key visibility no
  reader ever returns an advertised-but-missing child.

* **OCC** — every file record carries a monotone ``version`` used as a
  compare-and-swap token.  The engine-level CAS atomicity (which TABLEKV
  provides natively) is modeled by a per-store mutex around the
  compare+put pair; writers that observe a stale version abort and retry.

* **Invalidation stream** — every completed parent-after-child write
  publishes a path-keyed event; the cache tier (core/cache.py) subscribes
  and refreshes any entry whose key is a prefix of (or equal to) the
  affected path.  Bounded staleness R3: Δ = max queue-drain delay.

The writer exposes *stepwise* primitives (``admit_steps``) so property
tests can interleave reader operations between step 1 and step 2 and check
Theorem 2 under every schedule.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Iterator, Optional

from . import paths as P
from . import records as R
from .store import PathStore


@dataclass(frozen=True)
class Invalidation:
    """Path-keyed cache-invalidation event (paper §V-C)."""

    path: str
    seq: int


class InvalidationBus:
    """In-process pub/sub with an explicit drain step.

    Events are queued at publish time and delivered on ``drain()`` —
    making the staleness window Δ an explicit, testable quantity instead
    of a thread-timing accident.  ``subscribe`` callbacks receive each
    event exactly once, in publish order.

    ``journal`` (optional) is the durable-tier hook: every publish is
    also appended to the write-ahead log (``storage.DurableKV
    .journal_invalidation``), making the bus a *crash-safe* complete
    dirty-path log — after a restart the device tier rehydrates its
    pending ``TensorDelta`` work list from the journaled, committed
    publishes (see docs/STORAGE.md).
    """

    def __init__(self, journal: Callable[[str], None] | None = None):
        self._subs: list[Callable[[Invalidation], None]] = []
        self._queue: list[Invalidation] = []
        self._seq = 0
        self._lock = threading.Lock()
        self.journal = journal

    def subscribe(self, fn: Callable[[Invalidation], None]) -> None:
        self._subs.append(fn)

    def publish(self, path: str) -> Invalidation:
        with self._lock:
            self._seq += 1
            ev = Invalidation(path=path, seq=self._seq)
            self._queue.append(ev)
        if self.journal is not None:
            self.journal(path)
        return ev

    def drain(self) -> int:
        """Deliver all pending events; returns the number delivered."""
        with self._lock:
            batch, self._queue = self._queue, []
        for ev in batch:
            for fn in self._subs:
                fn(ev)
        return len(batch)

    def pending(self) -> int:
        return len(self._queue)


def attach_journal(bus: InvalidationBus | None, store) -> bool:
    """Wire a bus's publishes into a durable store's WAL (no-op for
    volatile stores or when a journal is already attached).  Returns
    whether the bus now journals."""
    if bus is None:
        return False
    if bus.journal is not None:
        return True
    if getattr(store, "durable", False):
        bus.journal = store.journal_invalidation
        return True
    return False


class CASConflict(RuntimeError):
    """An OCC update observed a stale version and exhausted its retries."""


class WikiWriter:
    """The single offline writer for one subtree (paper §IV-C).

    Multi-process construction partitions by author subtree; within one
    subtree the pipeline is serial, so one ``WikiWriter`` per subtree with
    no cross-writer coordination reproduces the deployment's model.
    """

    def __init__(self, store: PathStore, bus: InvalidationBus | None = None,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.bus = bus
        self.clock = clock
        # models engine-native CAS atomicity; reentrant because parent-chain
        # auto-creation recurses while holding the lock
        self._cas_lock = threading.RLock()

    # ------------------------------------------------------------------
    # parent-after-child admission
    # ------------------------------------------------------------------
    def admit_steps(self, path: str, rec: R.Record) -> Iterator[str]:
        """Generator yielding after each protocol step, for interleaving
        tests.  Step order is the theorem's: child first, parent second."""
        path = P.normalize(path, depth_budget=self.store.depth_budget)
        par = P.parent(path)
        is_dir = isinstance(rec, R.DirRecord)
        # step 1: child write
        self.store.put_record(path, rec)
        yield "child-written"
        # step 2: parent update (append segment)
        self._link_parent(par, P.basename(path), is_dir=is_dir)
        if self.bus is not None:
            self.bus.publish(path)
            self.bus.publish(par)
        yield "parent-updated"

    def admit(self, path: str, rec: R.Record) -> None:
        for _ in self.admit_steps(path, rec):
            pass

    def admit_subtree(self, items: list[tuple[str, R.Record]]) -> None:
        """Admit many nodes, parents-first in path depth order so every
        ``_link_parent`` finds its directory record present."""
        for path, rec in sorted(items, key=lambda it: P.depth(it[0])):
            if path == P.ROOT:
                self.put_record(path, rec)  # publishes like every write
                continue
            self.admit(path, rec)

    def ensure_root(self, summary: str = "") -> None:
        if self.store.get(P.ROOT) is None:
            self.put_record(
                P.ROOT, R.DirRecord(name="", summary=summary,
                                    meta=R.DirMeta(updated_at=self.clock())))

    # ------------------------------------------------------------------
    # raw write-through primitives (publish on every touched path)
    # ------------------------------------------------------------------
    # Every store mutation that flows through the writer publishes an
    # invalidation for the exact path it touched.  This is what makes the
    # bus a COMPLETE dirty-path log: the cache tier refreshes from it, and
    # engine.DeviceEngine materializes its per-epoch TensorDelta from it —
    # so evolution passes and errorbook repairs (which write through these
    # primitives) reach the device-resident index at the next refresh.
    def put_record(self, path: str, rec: R.Record) -> None:
        path = P.normalize(path, depth_budget=self.store.depth_budget)
        self.store.put_record(path, rec)
        if self.bus is not None:
            self.bus.publish(path)

    def delete_record(self, path: str) -> None:
        path = P.normalize(path, depth_budget=self.store.depth_budget)
        self.store.delete_record(path)
        if self.bus is not None:
            self.bus.publish(path)

    def get(self, path: str) -> Optional[R.Record]:
        return self.store.get(path)

    def _link_parent(self, par: str, segment: str, *, is_dir: bool) -> None:
        with self._cas_lock:
            prec = self.store.get(par)
            if prec is None:
                # auto-create the parent directory chain (bottom-up linking
                # preserves parent-after-child per level)
                prec = R.DirRecord(name=P.basename(par),
                                   meta=R.DirMeta(updated_at=self.clock()))
                self.store.put_record(par, prec)
                if par != P.ROOT:
                    self._link_parent(P.parent(par), P.basename(par), is_dir=True)
            if not isinstance(prec, R.DirRecord):
                raise ValueError(f"parent {par!r} is not a directory record")
            updated = prec.with_child(segment, is_dir=is_dir)
            updated = replace(updated, meta=replace(
                updated.meta, updated_at=self.clock()))
            self.store.put_record(par, updated)
            # publish every auto-created/updated ancestor level, not just
            # the immediate parent — the device delta must see the whole
            # chain of directory records whose child lists changed
            if self.bus is not None:
                self.bus.publish(par)

    # ------------------------------------------------------------------
    # page-level in-place rewrite under OCC (version CAS)
    # ------------------------------------------------------------------
    def update_file(self, path: str,
                    mutate: Callable[[R.FileRecord], R.FileRecord],
                    max_retries: int = 8) -> R.FileRecord:
        path = P.normalize(path, depth_budget=self.store.depth_budget)
        for _ in range(max_retries):
            rec = self.store.get(path)
            if rec is None or not isinstance(rec, R.FileRecord):
                raise KeyError(f"no file record at {path!r}")
            expected = rec.meta.version
            new = mutate(rec)
            new = replace(new, meta=replace(new.meta, version=expected + 1))
            with self._cas_lock:
                cur = self.store.get(path)
                if (isinstance(cur, R.FileRecord)
                        and cur.meta.version == expected):
                    self.store.put_record(path, new)
                    if self.bus is not None:
                        self.bus.publish(path)
                    return new
            # stale — retry with the latest value
        raise CASConflict(f"CAS retries exhausted for {path!r}")

    def unlink(self, path: str) -> None:
        """Remove a node: reverse order (parent first, child second) so a
        concurrent reader sees at worst an unadvertised orphan, never an
        advertised-but-missing child."""
        path = P.normalize(path, depth_budget=self.store.depth_budget)
        par = P.parent(path)
        with self._cas_lock:
            prec = self.store.get(par)
            if isinstance(prec, R.DirRecord):
                self.store.put_record(par, prec.without_child(P.basename(path)))
        self.store.delete_record(path)
        if self.bus is not None:
            self.bus.publish(path)
            self.bus.publish(par)


class ConsistentReader:
    """Skip-on-miss read protocol (paper §IV-C)."""

    def __init__(self, store: PathStore):
        self.store = store

    def get(self, path: str) -> Optional[R.Record]:
        return self.store.get(path)

    def ls(self, path: str) -> Optional[tuple[R.DirRecord, list[tuple[str, R.Record]]]]:
        """Directory listing that GETs every advertised child and silently
        drops ⊥ entries (the skip-on-miss discipline)."""
        out = self.store.ls(path)
        if out is None:
            return None
        rec, child_paths = out
        resolved: list[tuple[str, R.Record]] = []
        for cp in child_paths:
            crec = self.store.get(cp)
            if crec is None:
                continue  # skip-on-miss: drop advertised-but-missing entries
            resolved.append((cp, crec))
        return rec, resolved

"""Storage engines and the path-indexed facade (paper §IV).

Two layers:

* ``KVEngine`` — a minimal Put/Get/Delete/Scan contract (the paper's
  TABLEKV/LevelDB abstraction).  ``MemKV`` is an LSM-ish realization:
  a mutable memtable over immutable sorted runs with size-triggered
  compaction, so point reads and range scans have realistic asymmetric
  costs for the Table II study.

* ``PathStore`` — the WikiKV path-as-key facade.  Logical addresses are
  normalized paths; physical keys are the 8-byte FNV digest H(π)
  (``paths.key_bytes``).  A second column family holds the ordered path
  namespace (path-bytes → empty) to serve Q4 prefix scans natively, the
  way an LSM column family would.

The four query operators (paper §II-B):
  Q1  get(π)        → Record | None             (one point lookup)
  Q2  ls(π)         → (DirRecord, [child paths]) (one point lookup — children
                       are co-located in the directory record)
  Q3  navigate(π)   → [Record]                   (descend root→π, one GET per level)
  Q4  search(p)     → [π]                        (prefix range scan)
"""
from __future__ import annotations

import bisect
import threading
from typing import Iterator, Optional

from . import paths as P
from . import records as R


# One process-wide lock for every engine's op-counter dict: shard
# fan-outs run engine calls on executor worker threads, and the unlocked
# ``d[k] = d.get(k, 0) + 1`` read-modify-write would drop increments
# under contention — the seg_probe/bloom/cache counters must stay exact
# (tests hammer them multi-threaded).  Counter bumps are rare relative
# to reads, so one shared lock beats a per-engine allocation.
_OPS_LOCK = threading.Lock()


class KVEngine:
    """Minimal KV contract: all keys/values are bytes."""

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def scan(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Yield (key, value) for keys with byte-prefix ``prefix``, in order."""
        raise NotImplementedError

    def flush(self) -> None:  # pragma: no cover - engines may override
        pass

    # --- stats (fed to evolution operators and benches) ---
    def op_counts(self) -> dict[str, int]:
        with _OPS_LOCK:
            return dict(getattr(self, "_ops", {}))

    def _count(self, op: str) -> None:
        with _OPS_LOCK:
            ops = getattr(self, "_ops", None)
            if ops is None:
                ops = self._ops = {}
            ops[op] = ops.get(op, 0) + 1


_TOMBSTONE = object()


class MemKV(KVEngine):
    """LSM-ish in-process engine.

    Writes land in a dict memtable; when it exceeds ``memtable_limit``
    entries it is frozen into an immutable sorted run (parallel key/value
    lists).  Reads check the memtable, then runs newest-first via binary
    search.  ``compact()`` merges all runs.  Deletes write tombstones.
    This is deliberately the same read/write asymmetry as LevelDB so the
    Table II comparison is honest rather than a dict lookup in disguise.
    """

    def __init__(self, memtable_limit: int = 4096, auto_compact_runs: int = 8):
        self._mem: dict[bytes, object] = {}
        self._runs: list[tuple[list[bytes], list[object]]] = []  # newest last
        self._limit = memtable_limit
        self._auto = auto_compact_runs
        self._lock = threading.Lock()

    def put(self, key: bytes, value: bytes) -> None:
        self._count("put")
        with self._lock:
            self._mem[key] = value
            if len(self._mem) >= self._limit:
                self._freeze()

    def delete(self, key: bytes) -> None:
        self._count("delete")
        with self._lock:
            self._mem[key] = _TOMBSTONE
            if len(self._mem) >= self._limit:
                self._freeze()

    def get(self, key: bytes) -> Optional[bytes]:
        self._count("get")
        # snapshot under the lock: a concurrent put may _freeze() the
        # memtable mid-read (swap self._mem, append to self._runs)
        with self._lock:
            v = self._mem.get(key)
            runs = list(self._runs)
        if v is not None:
            return None if v is _TOMBSTONE else v  # type: ignore[return-value]
        for ks, vs in reversed(runs):
            i = bisect.bisect_left(ks, key)
            if i < len(ks) and ks[i] == key:
                v = vs[i]
                return None if v is _TOMBSTONE else v  # type: ignore[return-value]
        return None

    def scan(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        self._count("scan")
        # snapshot the memtable + run list under the lock before merging:
        # iterating self._mem.items() unlocked races a put that triggers
        # _freeze() ("dict changed size during iteration")
        with self._lock:
            mem_items = [(k, v) for k, v in self._mem.items()
                         if k.startswith(prefix)]
            runs = list(self._runs)
        # merge runs + memtable snapshot; newest wins
        merged: dict[bytes, object] = {}
        for ks, vs in runs:
            lo = bisect.bisect_left(ks, prefix)
            for i in range(lo, len(ks)):
                if not ks[i].startswith(prefix):
                    break
                merged[ks[i]] = vs[i]
        for k, v in mem_items:
            merged[k] = v
        for k in sorted(merged):
            v = merged[k]
            if v is not _TOMBSTONE:
                yield k, v  # type: ignore[misc]

    def _freeze(self) -> None:
        if not self._mem:
            return
        items = sorted(self._mem.items())
        self._runs.append(([k for k, _ in items], [v for _, v in items]))
        self._mem = {}
        if len(self._runs) >= self._auto:
            self._compact_locked()

    def compact(self) -> None:
        with self._lock:
            self._freeze()
            self._compact_locked()

    def _compact_locked(self) -> None:
        merged: dict[bytes, object] = {}
        for ks, vs in self._runs:
            for k, v in zip(ks, vs):
                merged[k] = v
        items = sorted((k, v) for k, v in merged.items() if v is not _TOMBSTONE)
        self._runs = [([k for k, _ in items], [v for _, v in items])] if items else []

    def flush(self) -> None:
        with self._lock:
            self._freeze()


class DictKV(KVEngine):
    """Plain-dict engine (no LSM costs) — used where engine cost must not
    pollute a measurement (e.g. protocol property tests)."""

    def __init__(self):
        self._d: dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes) -> None:
        self._count("put")
        self._d[key] = value

    def get(self, key: bytes) -> Optional[bytes]:
        self._count("get")
        return self._d.get(key)

    def delete(self, key: bytes) -> None:
        self._count("delete")
        self._d.pop(key, None)

    def scan(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        self._count("scan")
        for k in sorted(self._d):
            if k.startswith(prefix):
                yield k, self._d[k]


# namespace column-family prefixes inside one engine keyspace
_CF_DATA = b"d:"   # d:<8-byte digest>           -> record bytes
_CF_PATH = b"p:"   # p:<utf-8 normalized path>   -> 8-byte digest (ordered namespace)
_CF_TOKEN = b"t:"  # t:<token>:<path>            -> b"" (segment-token inverted index)


def _segment_tokens(path: str) -> set[str]:
    toks: set[str] = set()
    for seg in P.segments(path):
        low = seg.lower()
        toks.add(low)
        toks.update(t for t in low.replace("-", "_").split("_") if t)
    return toks


class PathStore:
    """WikiKV path-as-key store over any KVEngine (paper §IV-A/§IV-B)."""

    def __init__(self, engine: KVEngine | None = None,
                 depth_budget: int | None = P.DEFAULT_DEPTH_BUDGET):
        self.engine = engine if engine is not None else MemKV()
        self.depth_budget = depth_budget

    # -- physical key derivation ------------------------------------------
    @staticmethod
    def data_key(path: str) -> bytes:
        return _CF_DATA + P.key_bytes(path)

    @staticmethod
    def path_key(path: str) -> bytes:
        return _CF_PATH + path.encode("utf-8")

    # -- raw record plumbing (used by the consistency writer) --------------
    def put_record(self, path: str, rec: R.Record) -> None:
        path = P.normalize(path, depth_budget=self.depth_budget)
        self.engine.put(self.data_key(path), R.encode(rec))
        self.engine.put(self.path_key(path), P.key_bytes(path))
        # segment-token inverted index: keyword routing (NAV Phase 1)
        # stays O(hits) as the namespace grows (sub-linear scaling, §VI-F)
        pb = path.encode("utf-8")
        for tok in _segment_tokens(path):
            self.engine.put(_CF_TOKEN + tok.encode("utf-8") + b":" + pb, b"1")

    def delete_record(self, path: str) -> None:
        path = P.normalize(path, depth_budget=self.depth_budget)
        self.engine.delete(self.data_key(path))
        self.engine.delete(self.path_key(path))
        pb = path.encode("utf-8")
        for tok in _segment_tokens(path):
            self.engine.delete(_CF_TOKEN + tok.encode("utf-8") + b":" + pb)

    # -- Q1: path lookup ----------------------------------------------------
    def get(self, path: str) -> Optional[R.Record]:
        path = P.normalize(path, depth_budget=self.depth_budget)
        raw = self.engine.get(self.data_key(path))
        return R.decode(raw) if raw is not None else None

    # -- Q2: directory list (≡ one point lookup; children co-located) -------
    def ls(self, path: str) -> Optional[tuple[R.DirRecord, list[str]]]:
        path = P.normalize(path, depth_budget=self.depth_budget)
        rec = self.get(path)
        if rec is None or not isinstance(rec, R.DirRecord):
            return None
        return rec, [P.child(path, s) for s in rec.children()]

    # -- Q3: navigation along a known path (one GET per level) --------------
    def navigate(self, path: str) -> list[R.Record]:
        path = P.normalize(path, depth_budget=self.depth_budget)
        out: list[R.Record] = []
        for anc in list(P.ancestors(path)) + [path]:
            rec = self.get(anc)
            if rec is None:
                break
            out.append(rec)
        return out

    # -- Q4: prefix search over the ordered path namespace ------------------
    def search(self, prefix: str, limit: int | None = None) -> list[str]:
        prefix = prefix if prefix.startswith(P.SEP) else P.SEP + prefix
        out: list[str] = []
        for k, _ in self.engine.scan(self.path_key(prefix)):
            p = k[len(_CF_PATH):].decode("utf-8")
            # segment-aware: "/a" must not match "/ab"
            if not P.is_prefix(prefix.rstrip(P.SEP) or P.ROOT, p) and p != prefix:
                continue
            out.append(p)
            if limit is not None and len(out) >= limit:
                break
        return out

    def search_contains(self, token: str, limit: int | None = None) -> list[str]:
        """Keyword routing over the path namespace (NAV's EXTRACT→SEARCH).

        Served from the segment-token inverted index: one prefix scan over
        ``t:<token>:`` — O(hits), independent of namespace size.  Exact
        segment-token semantics: segments are indexed whole AND split on
        underscores, so "zhou" finds "/rel/zhou_zuoren"; a miss means no
        path carries the token (no O(N) fallback — that is what keeps
        routing sub-linear, §VI-F)."""
        token_l = token.lower()
        out = []
        for k, _ in self.engine.scan(_CF_TOKEN + token_l.encode("utf-8") + b":"):
            p = k.split(b":", 2)[2].decode("utf-8")
            out.append(p)
            if limit is not None and len(out) >= limit:
                break
        return out

    # -- namespace enumeration (offline pipeline / evolution operators) -----
    def all_paths(self) -> list[str]:
        return [k[len(_CF_PATH):].decode("utf-8")
                for k, _ in self.engine.scan(_CF_PATH)]

    def count(self) -> int:
        """Number of live paths (one ordered-namespace scan)."""
        return sum(1 for _ in self.engine.scan(_CF_PATH))

    def op_counts(self) -> dict[str, int]:
        """Engine-level op counters (put/get/scan plus, on a durable
        engine, ``bloom_neg``/``cache_hit``/``cache_miss``) — the same
        shape ``ShardedPathStore.op_counts`` aggregates per shard."""
        return self.engine.op_counts()

    # -- engine maintenance / durable-tier passthroughs ---------------------
    # Duck-typed delegation so the facade works unchanged over MemKV,
    # DictKV, or storage.DurableKV; callers probe the same names on
    # ShardedPathStore, which fans them out per shard.
    @property
    def durable(self) -> bool:
        return hasattr(self.engine, "journal_invalidation")

    def flush(self) -> None:
        self.engine.flush()

    def compact(self) -> None:
        if hasattr(self.engine, "compact"):
            self.engine.compact()

    def close(self) -> None:
        if hasattr(self.engine, "close"):
            self.engine.close()

    def commit_epoch(self, epoch: int) -> None:
        """Group-commit the engine's buffered wave at ``epoch`` (WAL
        COMMIT marker on a durable engine; no-op on volatile ones)."""
        if hasattr(self.engine, "commit_epoch"):
            self.engine.commit_epoch(epoch)

    def seal_commit(self, epoch: int):
        """Synchronous half of a pipelined group commit: seal the
        engine's buffered wave under its lock and return the deferred
        durability closure (WAL write + fsync + spill) for the commit
        sequencer to run off-thread.  None when there is nothing to make
        durable — or when the engine is volatile / pre-pipeline, in
        which case this degrades to a plain synchronous commit."""
        fn = getattr(self.engine, "seal_commit", None)
        if fn is None:
            self.commit_epoch(epoch)
            return None
        return fn(epoch)

    def durable_epoch(self) -> int:
        """Newest epoch advertised as durable.  A synchronous commit
        path never advertises ahead of the WAL, so this is simply the
        last committed epoch; ``ShardedPathStore`` overrides it with the
        commit sequencer's landed-fsync watermark when pipelining."""
        return self.last_epoch()

    def compact_debt(self) -> int | None:
        """Outstanding merge bytes owed by a durable engine (the
        compaction backpressure gauge); None on volatile engines."""
        fn = getattr(self.engine, "compact_debt", None)
        return None if fn is None else fn()

    def last_epoch(self) -> int:
        if hasattr(self.engine, "last_epoch"):
            return self.engine.last_epoch()
        return 0

    def journal_invalidation(self, path: str) -> None:
        if hasattr(self.engine, "journal_invalidation"):
            self.engine.journal_invalidation(path)

    def mark_device_epoch(self, epoch: int) -> None:
        if hasattr(self.engine, "mark_device_epoch"):
            self.engine.mark_device_epoch(epoch)

    def pending_invalidations(self) -> list[str]:
        if hasattr(self.engine, "pending_invalidations"):
            return self.engine.pending_invalidations()
        return []

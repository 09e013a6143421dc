"""``DurableKV`` — the disk-backed LSM engine behind the ``KVEngine``
protocol (ISSUE 3 tentpole; leveled compaction + bloom filters + block
cache since ISSUE 7; key-range-partitioned levels + compaction
backpressure since ISSUE 9).

Write path: every put/delete appends a WAL record (buffered) and lands in
the dict memtable.  ``commit_epoch(e)`` — called once per planner wave by
``QueryEngine.refresh()``, or via ``flush()`` between offline batches —
group-commits the buffered wave to the WAL; when the memtable exceeds its
limit the commit also *spills* it to a sorted level-0 segment and swaps
the manifest, after which the WAL is truncated (everything it held is now
in a segment).

Compaction is leveled with key-range-partitioned levels ≥ 1:

* Level 0 holds whole-memtable spills (overlapping ranges); when it
  accumulates ``level_ratio`` segments (default 4, ``REPRO_LEVEL_RATIO``)
  the whole run is merged down.
* Levels ≥ 1 hold segments with **disjoint key ranges**, split at
  ``REPRO_SEGMENT_TARGET_BYTES`` (default 2 MiB) per output partition.
  A level is triggered when its bytes exceed
  ``segment_target_bytes · level_ratio^level``; the merge picks one
  victim partition (the largest — fastest debt paydown) plus the
  range-overlapping partitions of the next level, and rewrites only
  those.  Merged bytes per trigger are O(victim + overlap), never
  O(level), and never O(total store).
* A legacy (pre-partitioned or migrated) level with unknown or
  overlapping ranges is merged whole, which partitions it — stores
  migrate themselves during normal operation.

Merges are throttled: ``REPRO_COMPACT_BUDGET_BYTES`` (0 = unlimited)
bounds the merged bytes per ``commit_epoch`` boundary.  A merge that
exhausts the budget *pauses* after the partition it is writing:
completed output partitions plus a resume key are recorded in the
manifest (format 3 ``compaction`` field) by the same atomic
write-then-swap that protects every other transition, the inputs stay
live for readers, and the next wave resumes from the recorded key.  The
outstanding work is exported as the ``compact_debt`` gauge (see
:meth:`compact_debt`) so the serving tier can observe backpressure.
``compact()`` remains the explicit *major* compaction (merge everything
to the bottom level, partitioned, dropping all tombstones — the
maintenance/benchmark path); it abandons any paused merge first (the
paused outputs are redundant copies of still-live inputs).

Read path: memtable first, then levels in order.  On a partitioned
level the probe is a binary search over the partition ranges — **at
most one segment per level** is consulted; level 0 (and any legacy
level) is probed newest-first.  Each consulted segment is counted as
``seg_probe`` and bloom-checked first (``REPRO_BLOOM_BITS`` bits/key,
default 10; the key is hashed once per lookup, not once per segment).
An optional shared :class:`~repro.storage.sstable.BlockCache`
(``REPRO_BLOCK_CACHE_BYTES``) serves hot index blocks from memory.
``scan`` k-way-merges only the segments whose key range can intersect
the prefix (first-seen-wins across memtable → L0 newest-first → deeper
levels).

Crash recovery (``recover()``, run at construction): load the manifest,
validate any paused-merge state, sweep orphan segments (a paused
merge's recorded outputs are *not* orphans), open the live segments,
replay the WAL's committed waves over them, truncate any
uncommitted/corrupt tail.  Guarantees:

* a crash loses at most the wave that had not yet committed (Δ = 1 wave
  across restart — the engine-layer tests assert this end to end);
* a torn WAL tail is detected by CRC and cleanly dropped;
* a crash between segment write and manifest swap — spill, merge
  partition, or merge finalize — leaves orphan files that recovery
  deletes: the manifest still references the pre-crash inputs, so the
  store's view is the pre-compaction one and nothing is lost or
  duplicated (WAL replay over segments is idempotent);
* a crash after a budget pause resumes the merge from the recorded
  key: the already-written partitions are kept, not redone.

The randomized crash-injection harness (tests/test_storage_fuzz.py,
``storage.failpoints``) exercises all of the above against an oracle.

Epoch rehydration: COMMIT records carry the write epoch and DEVMARK
records the epoch the device tier last applied; INV records journal
every invalidation-bus publish.  After restart, ``last_epoch()`` restores
the engine epoch and ``pending_invalidations()`` returns the committed
dirty paths the device tier had NOT yet applied — the exact
``TensorDelta`` work list for its first post-restart ``refresh()``.
"""
from __future__ import annotations

import bisect
import heapq
import os
import threading
from typing import Callable, Iterator, Optional

from .. import obs
from ..core import paths as P
from ..core.store import KVEngine, PathStore
from . import manifest as MF
from . import wal as W
from .sstable import (MISSING, TOMBSTONE, BlockCache, SSTable,
                      bloom_hash_pair, write_sstable)

WAL_NAME = "wikikv.wal"

#: ``REPRO_LEVEL_RATIO`` — L0 segment-count trigger, and the per-level
#: byte-capacity growth factor for levels ≥ 1 (default 4, min 2)
LEVEL_RATIO_ENV = "REPRO_LEVEL_RATIO"
#: ``REPRO_BLOOM_BITS`` — bloom bits per key written into new segment
#: footers (default 10 ≈ 0.8% FPR at k=7; 0 disables → PR-3 byte layout)
BLOOM_BITS_ENV = "REPRO_BLOOM_BITS"
#: ``REPRO_BLOCK_CACHE_BYTES`` — byte budget of the block cache
#: ``open_durable_store`` shares across shards (default 8 MiB; 0 disables)
BLOCK_CACHE_ENV = "REPRO_BLOCK_CACHE_BYTES"
#: ``REPRO_SEGMENT_TARGET_BYTES`` — partition size compaction splits its
#: outputs at; also the base of the per-level byte capacity
#: ``target · ratio^level`` (default 2 MiB)
SEGMENT_TARGET_ENV = "REPRO_SEGMENT_TARGET_BYTES"
#: ``REPRO_COMPACT_BUDGET_BYTES`` — merged bytes allowed per
#: ``commit_epoch`` boundary before the merge pauses resumably
#: (default 0 = unlimited, i.e. no backpressure throttling)
COMPACT_BUDGET_ENV = "REPRO_COMPACT_BUDGET_BYTES"
#: ``REPRO_BG_COMPACT`` — run budgeted merges on a per-store daemon
#: worker: ``commit_epoch`` enqueues compaction debt instead of paying
#: it inline (default 0 = inline, the pre-ISSUE-10 behavior)
BG_COMPACT_ENV = "REPRO_BG_COMPACT"

_TRUTHY = ("1", "true", "on", "yes")


def resolve_level_ratio(explicit: int | None = None) -> int:
    """Resolve the per-level compaction trigger (arg > env > default 4)."""
    val = explicit if explicit is not None else \
        int(os.environ.get(LEVEL_RATIO_ENV, "4"))
    if val < 2:
        raise ValueError(f"level_ratio must be >= 2, got {val}")
    return val


def resolve_bloom_bits(explicit: int | None = None) -> int:
    """Resolve bloom bits/key for new segments (arg > env > default 10)."""
    val = explicit if explicit is not None else \
        int(os.environ.get(BLOOM_BITS_ENV, "10"))
    if val < 0:
        raise ValueError(f"bloom_bits must be >= 0, got {val}")
    return val


def resolve_segment_target_bytes(explicit: int | None = None) -> int:
    """Resolve the partition target size (arg > env > default 2 MiB)."""
    val = explicit if explicit is not None else \
        int(os.environ.get(SEGMENT_TARGET_ENV, str(2 << 20)))
    if val < 1:
        raise ValueError(f"segment_target_bytes must be >= 1, got {val}")
    return val


def resolve_compact_budget_bytes(explicit: int | None = None) -> int:
    """Resolve the per-commit merge budget (arg > env > default 0 =
    unlimited)."""
    val = explicit if explicit is not None else \
        int(os.environ.get(COMPACT_BUDGET_ENV, "0"))
    if val < 0:
        raise ValueError(f"compact_budget_bytes must be >= 0, got {val}")
    return val


def resolve_bg_compact(explicit: bool | None = None) -> bool:
    """Resolve the background-compaction switch (arg > env > default
    off = merges run inline at the commit boundary)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(BG_COMPACT_ENV, "0").strip().lower() in _TRUTHY


def default_block_cache(explicit_bytes: int | None = None
                        ) -> BlockCache | None:
    """Build the shared block cache ``open_durable_store`` hands every
    shard (arg > env > default 8 MiB); 0 bytes → no cache (None)."""
    val = explicit_bytes if explicit_bytes is not None else \
        int(os.environ.get(BLOCK_CACHE_ENV, str(8 << 20)))
    if val < 0:
        raise ValueError(f"block cache bytes must be >= 0, got {val}")
    return BlockCache(val) if val else None


def _meta_range(m: MF.SegmentMeta) -> tuple[bytes, bytes] | None:
    """A segment's decoded key range, or None when unknown (migrated
    PR-3 metadata, or an empty-key edge case)."""
    if m.records > 0 and m.min_key and m.max_key:
        return bytes.fromhex(m.min_key), bytes.fromhex(m.max_key)
    return None


class _LevelView:
    """Read-path view of one level, rebuilt on every manifest change.

    ``partitioned`` means every segment's range is known and the ranges
    are pairwise disjoint — then ``mins``/``maxs`` (ascending) drive a
    binary search and a point read consults at most one segment.
    Otherwise ``entries`` is newest-first and every segment is a probe
    candidate (level 0, legacy levels, ``flat_reads`` mode)."""

    __slots__ = ("level", "partitioned", "entries", "mins", "maxs")

    def __init__(self, level: int, partitioned: bool, entries: list,
                 mins: list | None = None, maxs: list | None = None):
        self.level = level
        self.partitioned = partitioned
        self.entries = entries          # [(SegmentMeta, SSTable)]
        self.mins = mins
        self.maxs = maxs


class DurableKV(KVEngine):
    """Durable memtable → WAL → leveled-SSTable engine; one directory per
    engine (per digest-range shard under ``ShardedPathStore``).

    Args: ``dirname`` store directory (created; recovered if it already
    holds a store), ``memtable_limit`` entries before a commit spills,
    ``sync`` WAL sync mode (None → ``REPRO_WAL_SYNC``), ``level_ratio``
    L0 trigger + capacity growth factor (None → ``REPRO_LEVEL_RATIO``),
    ``bloom_bits`` filter bits/key for new segments (None →
    ``REPRO_BLOOM_BITS``; 0 writes PR-3-layout segments), ``block_cache``
    a shared :class:`BlockCache` or None (no cache — the default for a
    bare engine; ``open_durable_store`` wires a shared one),
    ``segment_target_bytes`` compaction partition size (None →
    ``REPRO_SEGMENT_TARGET_BYTES``), ``compact_budget_bytes`` merged
    bytes allowed per commit boundary (None →
    ``REPRO_COMPACT_BUDGET_BYTES``; 0 = unlimited), ``flat_reads``
    disable the per-level binary search and probe every segment — the
    benchmark A/B switch that reproduces the pre-partitioned (PR-5)
    read path on the same files, ``bg_compact`` move budgeted merges to
    a per-store daemon worker so ``commit_epoch`` enqueues debt instead
    of paying it (None → ``REPRO_BG_COMPACT``; the budget still bounds
    each worker slice, so backpressure flow control is unchanged)."""

    def __init__(self, dirname: str, memtable_limit: int = 4096,
                 sync: str | None = None, level_ratio: int | None = None,
                 bloom_bits: int | None = None,
                 block_cache: BlockCache | None = None,
                 segment_target_bytes: int | None = None,
                 compact_budget_bytes: int | None = None,
                 flat_reads: bool = False,
                 bg_compact: bool | None = None):
        self.dirname = dirname
        self._limit = memtable_limit
        self._ratio = resolve_level_ratio(level_ratio)
        self._bloom_bits = resolve_bloom_bits(bloom_bits)
        self._cache = block_cache
        self._sync = W.sync_mode(sync)
        self._target = resolve_segment_target_bytes(segment_target_bytes)
        self._budget = resolve_compact_budget_bytes(compact_budget_bytes)
        self._flat_reads = bool(flat_reads)
        self._lock = threading.RLock()
        self._mem: dict[bytes, object] = {}
        #: memtable sealed by a pipelined commit, awaiting its off-thread
        #: spill — reads consult it between the live memtable and levels
        self._frozen: dict[bytes, object] | None = None
        self._tables: dict[str, SSTable] = {}  # segment name -> open reader
        self._read_order: list[tuple[MF.SegmentMeta, SSTable]] = []
        self._levels: list[_LevelView] = []
        self._inval_buf: list[str] = []        # journaled, not yet committed
        self._closed = False
        #: merged bytes spent by the most recent commit/spill boundary —
        #: the per-wave compaction cost the backpressure tests assert on
        self.last_compact_bytes = 0
        # background compaction worker state (started below, after
        # recovery, so a recovered paused merge can resume immediately)
        self._bg = resolve_bg_compact(bg_compact)
        self._bg_thread: threading.Thread | None = None
        self._bg_wake = threading.Event()
        self._bg_stop = threading.Event()
        self._bg_exc: BaseException | None = None
        os.makedirs(dirname, exist_ok=True)
        self._recover()
        wal_path = os.path.join(dirname, WAL_NAME)
        wal_existed = os.path.exists(wal_path)
        self._wal = W.WAL(wal_path, sync=self._sync)
        if self._sync == "fsync" and not wal_existed:
            # a freshly created WAL's directory entry must be durable
            # before any commit claims its contents are
            W.fsync_dir(dirname)
        if self._bg:
            self._bg_thread = threading.Thread(
                target=self._bg_loop, name=f"lsm-compact:{dirname}",
                daemon=True)
            self._bg_thread.start()
            with self._lock:
                if self._compact_debt_locked() > 0:
                    self._bg_wake.set()

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def _open_table(self, name: str) -> SSTable:
        return SSTable(os.path.join(self.dirname, name),
                       cache=self._cache, stat=self._count)

    def _rebuild_read_order(self) -> None:
        """Recompute the per-level read views and the flat probe order
        (levels ascending; newest-first within a non-partitioned level,
        range-ascending within a partitioned one)."""
        segs = self._manifest.segments
        by_level: dict[int, list[int]] = {}
        for i, m in enumerate(segs):
            by_level.setdefault(m.level, []).append(i)
        views: list[_LevelView] = []
        for level in sorted(by_level):
            idxs = by_level[level]
            ranges = [_meta_range(segs[i]) for i in idxs]
            view = None
            if level >= 1 and not self._flat_reads and all(ranges):
                ordered = sorted(zip(ranges, idxs), key=lambda t: t[0])
                disjoint = all(ordered[j][0][0] > ordered[j - 1][0][1]
                               for j in range(1, len(ordered)))
                if disjoint:
                    view = _LevelView(
                        level, True,
                        [(segs[i], self._tables[segs[i].name])
                         for _, i in ordered],
                        mins=[r[0] for r, _ in ordered],
                        maxs=[r[1] for r, _ in ordered])
            if view is None:
                # L0, legacy metadata, or flat_reads: probe every
                # segment newest-first (later manifest position = newer)
                view = _LevelView(
                    level, False,
                    [(segs[i], self._tables[segs[i].name])
                     for i in reversed(idxs)])
            views.append(view)
        self._levels = views
        self._read_order = [e for v in views for e in v.entries]

    def _recover(self) -> None:
        """Manifest → paused-merge validation → orphan sweep → open
        segments → WAL replay → truncate the uncommitted/corrupt tail
        (see module docstring)."""
        with obs.span("lsm.recover") as sp:
            self._recover_impl()
            sp.set(waves=self._epoch, dropped=self.recovery_dropped)

    def _recover_impl(self) -> None:
        m = MF.load(self.dirname)
        st = m.compaction
        if st is not None:
            # a paused merge is only resumable if its inputs are still
            # live and every recorded output file exists; anything else
            # (defensive — no crash point produces it) is abandoned and
            # the sweep below reclaims the output files
            names = set(m.segment_names())
            ok = (all(n in names for n in st.inputs)
                  and all(os.path.exists(os.path.join(self.dirname, o.name))
                          for o in st.outputs))
            if not ok:
                m.compaction = None
        MF.sweep_orphans(self.dirname, m)
        self._manifest = m
        self._tables = {meta.name: self._open_table(meta.name)
                        for meta in m.segments}
        self._rebuild_read_order()
        self._epoch = m.epoch
        self._device_epoch = m.device_epoch
        self._pending_inval: list[str] = list(m.pending_inval)
        wal_path = os.path.join(self.dirname, WAL_NAME)
        res = W.replay(wal_path)
        for wave in res.waves:
            for rec in wave:
                if rec.kind == W.PUT:
                    self._mem[rec.key] = rec.value
                elif rec.kind == W.DEL:
                    self._mem[rec.key] = TOMBSTONE
                elif rec.kind == W.INV:
                    self._pending_inval.append(rec.path)
                elif rec.kind == W.DEVMARK:
                    self._device_epoch = max(self._device_epoch, rec.epoch)
                    self._pending_inval.clear()
                elif rec.kind == W.COMMIT:
                    self._epoch = max(self._epoch, rec.epoch)
        self.recovery_dropped = res.dropped_records
        self.recovery_corrupt_tail = res.corrupt_tail
        if res.dropped_records or res.corrupt_tail:
            # drop the uncommitted wave / torn tail so the next append
            # starts at a clean frame boundary
            with open(wal_path, "rb+") as f:
                f.truncate(res.valid_end)

    # ------------------------------------------------------------------
    # KVEngine surface
    # ------------------------------------------------------------------
    def _raise_bg(self) -> None:
        """Surface a background-worker failure (IO error, injected
        crash) on the caller thread: sticky — once the worker has died,
        every subsequent mutation re-raises until close().  Callers must
        hold no assumption that the merge it was running completed."""
        exc = self._bg_exc
        if exc is not None:
            raise exc

    def put(self, key: bytes, value: bytes) -> None:
        """Upsert ``key`` → WAL buffer + memtable (durable at the next
        ``commit_epoch``).  O(1)."""
        self._count("put")
        self._raise_bg()
        with self._lock:
            self._wal.append_put(key, value)
            self._mem[key] = value

    def delete(self, key: bytes) -> None:
        """Tombstone ``key`` (shadows every older level until a bottom
        merge drops it).  O(1)."""
        self._count("delete")
        self._raise_bg()
        with self._lock:
            self._wal.append_delete(key)
            self._mem[key] = TOMBSTONE

    def get(self, key: bytes) -> Optional[bytes]:
        """Point lookup: memtable, then levels in order — a binary
        search over the partition ranges on a partitioned level (≤ 1
        segment consulted), newest-first probe-all on level 0 / legacy
        levels.

        Complexity: O(1) memtable hit; otherwise O(log partitions) per
        partitioned level and O(segments) on level 0.  Every consulted
        segment counts as ``seg_probe`` in :meth:`op_counts`; the key is
        bloom-hashed **once** and a negative filter skips the segment
        (``bloom_neg``) before any of its bytes are touched.  Surviving
        probes cost O(log n_index) bisect + one ≤ SPARSE_EVERY-record
        block (served from the shared block cache when attached:
        ``cache_hit``/``cache_miss`` counters)."""
        self._count("get")
        with self._lock:
            v = self._mem.get(key)
            if v is None and self._frozen is not None:
                # sealed by a pipelined commit, spill still in flight
                v = self._frozen.get(key)
            if v is not None:
                return None if v is TOMBSTONE else v  # type: ignore[return-value]
            hashes: tuple[int, int] | None = None
            for view in self._levels:
                if view.partitioned:
                    i = bisect.bisect_right(view.mins, key) - 1
                    if i < 0 or key > view.maxs[i]:
                        continue
                    cands = (view.entries[i],)
                else:
                    cands = view.entries
                for meta, seg in cands:
                    self._count("seg_probe")
                    if seg.bloom is not None:
                        if hashes is None:
                            hashes = bloom_hash_pair(key)
                        if not seg.bloom.may_contain_hashes(*hashes):
                            self._count("bloom_neg")
                            continue
                    v = seg.get(key)
                    if v is TOMBSTONE:
                        return None
                    if v is not MISSING:
                        return v  # type: ignore[return-value]
        return None

    def scan(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Ordered iteration over live ``prefix``-keyed pairs (tombstones
        resolved): a k-way merge over the memtable and only the segments
        whose key range can intersect the prefix (``scan_skip`` counts
        the pruned ones).  First occurrence of a key in merge-rank order
        — memtable, then levels ascending, newest-first within level 0 —
        wins; partitioned levels are disjoint so rank among their
        partitions cannot matter.  Scans bypass bloom filters and the
        block cache by design (range reads would pollute it)."""
        self._count("scan")
        plen = len(prefix)
        with self._lock:
            runs: list[list[tuple[bytes, int, object]]] = []
            mem = sorted((k, v) for k, v in self._mem.items()
                         if k.startswith(prefix))
            runs.append([(k, 0, v) for k, v in mem])
            if self._frozen is not None:
                # the sealed-not-yet-spilled wave: older than the live
                # memtable, newer than every segment
                frz = sorted((k, v) for k, v in self._frozen.items()
                             if k.startswith(prefix))
                runs.append([(k, 1, v) for k, v in frz])
            rank = 2
            for view in self._levels:
                for meta, seg in view.entries:
                    r = _meta_range(meta)
                    if r is not None and (
                            r[1] < prefix or (plen and r[0][:plen] > prefix)):
                        self._count("scan_skip")
                        continue
                    runs.append([(k, rank, v) for k, v in seg.scan(prefix)])
                    rank += 1
            out: list[tuple[bytes, bytes]] = []
            last: bytes | None = None
            # (key, rank) pairs are unique across runs, so the merge
            # never compares values; the lowest rank for a key comes
            # first and shadows the rest
            for k, _, v in heapq.merge(*runs):
                if k == last:
                    continue
                last = k
                if v is not TOMBSTONE:
                    out.append((k, v))  # type: ignore[arg-type]
        yield from out

    def flush(self) -> None:
        """KVEngine hygiene hook (offline pipeline batches): commit the
        buffered wave at the current epoch — durability without an epoch
        bump."""
        self.commit_epoch(self._epoch)

    # ------------------------------------------------------------------
    # group commit + spill (the wave boundary)
    # ------------------------------------------------------------------
    def commit_epoch(self, epoch: int) -> None:
        """Group-commit the buffered wave at ``epoch`` (monotone), spill
        the memtable if over its limit, then pay compaction debt up to
        the per-wave byte budget — inline, or by waking the background
        worker when ``bg_compact`` is on."""
        self._raise_bg()
        with self._lock:
            # monotone: a lagging engine sharing this store (e.g. a
            # device mirror whose own counter trails the host's) must
            # never move the committed epoch backwards
            epoch = max(epoch, self._epoch)
            if (epoch == self._epoch and self._wal.pending_bytes() == 0
                    and not self._inval_buf and len(self._mem) < self._limit):
                # same epoch, nothing to make durable: skip the COMMIT
                # frame and its fsync, so repeated flush() calls never
                # grow the WAL with redundant empty waves.  An epoch
                # ADVANCE is always recorded, even content-free — the
                # committed epoch sequence must survive restart.
                return
            self._wal.commit(epoch)
            self._epoch = epoch
            self._manifest.epoch = epoch
            self._pending_inval.extend(self._inval_buf)
            self._inval_buf.clear()
            if len(self._mem) >= self._limit:
                self._spill_locked()
            self._kick_compaction_locked()

    def seal_commit(self, epoch: int):
        """Synchronous half of a pipelined group commit (monotone, same
        skip rule as :meth:`commit_epoch`).  Under the lock: seal the
        WAL buffer (cheap byte copy — no IO), advance the epoch
        bookkeeping, and *freeze* an over-limit memtable so the next
        wave's writes land in a fresh one.  Returns None when there is
        nothing to commit, else a zero-arg ``complete`` closure for the
        commit sequencer: it writes + fsyncs the sealed bytes WITHOUT
        the engine lock (so the fsync overlaps the caller's compute),
        then — back under the lock — spills the frozen memtable and
        kicks compaction.  The caller must run ``complete`` exactly once
        and join it before the next seal (the sequencer's depth-1
        invariant); until it finishes, the epoch is sealed but NOT
        durable and must not be advertised as such."""
        with self._lock:
            self._raise_bg()
            epoch = max(epoch, self._epoch)
            if (epoch == self._epoch and self._wal.pending_bytes() == 0
                    and not self._inval_buf and len(self._mem) < self._limit):
                return None
            sealed = self._wal.seal(epoch)
            self._epoch = epoch
            self._manifest.epoch = epoch
            self._pending_inval.extend(self._inval_buf)
            self._inval_buf.clear()
            if len(self._mem) >= self._limit:
                assert self._frozen is None, \
                    "pipelined commit overlap exceeded depth 1"
                self._frozen = self._mem
                self._mem = {}

        def complete() -> None:
            self._wal.write_sealed(sealed, epoch)
            with self._lock:
                self._spill_frozen_locked()
                self._kick_compaction_locked()
        return complete

    def spill(self) -> None:
        """Commit the open wave and force the memtable to a level-0
        segment regardless of the limit (then run any triggered leveled
        merges).  Maintenance/benchmark hook: after it, every committed
        record is served from segment files — a truly cold read path."""
        self._raise_bg()
        with self._lock:
            if self._wal.pending_bytes() or self._inval_buf:
                self.commit_epoch(self._epoch)
            self._spill_locked()
            self._kick_compaction_locked()

    def _store_manifest_locked(self) -> None:
        """Swap the manifest carrying the LIVE counters, not whatever it
        held on disk: after a reopen the committed epoch may exist only
        in WAL COMMIT records, and a spill's WAL reset truncates those."""
        self._manifest.epoch = self._epoch
        self._manifest.device_epoch = self._device_epoch
        self._manifest.pending_inval = list(self._pending_inval)
        MF.store(self.dirname, self._manifest, sync=self._sync == "fsync")

    def _spill_locked(self) -> None:
        """Freeze the (fully committed) memtable into a new level-0
        segment and make it live: segment write + fsync → manifest swap →
        WAL truncate.  Each arrow is a crash boundary recovery handles
        (orphan sweep / idempotent WAL replay)."""
        if not self._mem:
            return
        with obs.span("lsm.spill", records=len(self._mem)):
            self._spill_items_locked(self._mem)
            self._mem = {}

    def _spill_frozen_locked(self) -> None:
        """Spill the memtable a pipelined ``seal_commit`` froze (no-op
        if it froze none).  Runs on the sequencer worker; the WAL
        truncate inside preserves the next wave's buffered appends
        (``WAL.truncate`` drops the file, not the buffer).  The frozen
        dict is released only after the manifest swap succeeds, so a
        failure here leaves it readable and its records replayable."""
        if self._frozen is None:
            return
        if self._frozen:
            with obs.span("lsm.spill", records=len(self._frozen)):
                self._spill_items_locked(self._frozen)
        self._frozen = None

    def _spill_items_locked(self, mem: dict) -> None:
        name = self._manifest.alloc_segment()
        path = os.path.join(self.dirname, name)
        stats = write_sstable(path, sorted(mem.items()),
                              sync=self._sync == "fsync",
                              bloom_bits_per_key=self._bloom_bits)
        self._manifest.segments.append(MF.SegmentMeta(
            name=name, level=0, records=stats.n_records,
            bytes=stats.file_bytes,
            min_key=stats.min_key.hex(), max_key=stats.max_key.hex(),
            bloom_k=stats.bloom_k, bloom_bits=stats.bloom_nbits))
        self._store_manifest_locked()
        self._tables[name] = self._open_table(name)
        self._rebuild_read_order()
        self._wal.truncate()

    # ------------------------------------------------------------------
    # leveled compaction: partitioned, budgeted, resumable
    # ------------------------------------------------------------------
    def _cap_bytes(self, level: int) -> int:
        """Byte capacity of ``level``: ``target · ratio^level``."""
        return self._target * (self._ratio ** level)

    def _level_bytes(self) -> dict[int, int]:
        lb: dict[int, int] = {}
        for m in self._manifest.segments:
            lb[m.level] = lb.get(m.level, 0) + m.bytes
        return lb

    def _pick_trigger_locked(self) -> int | None:
        """→ the shallowest level owing a merge: L0 by segment count,
        levels ≥ 1 by byte capacity; None when no level is over."""
        counts = self._manifest.level_counts()
        if counts.get(0, 0) >= self._ratio:
            return 0
        lb = self._level_bytes()
        for level in sorted(lb):
            if level >= 1 and lb[level] > self._cap_bytes(level):
                return level
        return None

    def _begin_compaction_locked(self, level: int) -> MF.CompactionState:
        """Freeze one merge's shape: inputs (victim + range-overlapping
        next-level partitions), output level, and whether tombstones may
        drop — recorded once so a later resume cannot change semantics."""
        segs = self._manifest.segments
        part = {v.level: v.partitioned for v in self._levels}
        src = [m for m in segs if m.level == level]
        if level >= 1 and part.get(level, False):
            # one victim partition: the largest pays the debt down
            # fastest; peers are disjoint so they can stay put
            inputs = [max(src, key=lambda m: (m.bytes, m.name))]
        else:
            # L0 ranges overlap (and a legacy level's may): the whole
            # run must move together or shadowing order would invert
            inputs = list(src)
        out_level = level + 1
        nxt = [m for m in segs if m.level == out_level]
        if nxt:
            if part.get(out_level, False):
                ranges = [_meta_range(m) for m in inputs]
                if all(ranges):
                    lo = min(r[0] for r in ranges)
                    hi = max(r[1] for r in ranges)
                    overlap = [m for m in nxt
                               if not (bytes.fromhex(m.max_key) < lo
                                       or bytes.fromhex(m.min_key) > hi)]
                else:
                    overlap = list(nxt)     # unknown span: take everything
            else:
                # merging INTO an unpartitioned level partitions it,
                # but only if the whole level is rewritten
                overlap = list(nxt)
            inputs = inputs + overlap
        drop = not any(m.level > out_level for m in segs)
        return MF.CompactionState(
            level=level, out_level=out_level,
            inputs=[m.name for m in inputs], outputs=[],
            next_key="", drop_tombstones=drop)

    def _merge_inputs_locked(self, st: MF.CompactionState
                             ) -> list[tuple[bytes, object]]:
        """Re-derive the merge's sorted item stream from its live inputs
        (deterministic, so a resume reproduces the exact same stream)."""
        pos = {m.name: i for i, m in enumerate(self._manifest.segments)}
        names = set(st.inputs)
        metas = [m for m in self._manifest.segments if m.name in names]
        merged: dict[bytes, object] = {}
        # oldest version first so newer overwrites: deeper level first,
        # then chronological manifest position within a level
        for m in sorted(metas, key=lambda m: (-m.level, pos[m.name])):
            for k, v in self._tables[m.name].iter_all():
                merged[k] = v
        if st.drop_tombstones:
            return sorted((k, v) for k, v in merged.items()
                          if v is not TOMBSTONE)
        return sorted(merged.items())

    def _partition_spans(self, items: list) -> Iterator[tuple[int, int]]:
        """Split points: each span is ≥ 1 record and crosses the target
        size by at most one record (estimated as klen + vlen + 8)."""
        i, n = 0, len(items)
        while i < n:
            est, j = 0, i
            while j < n and (j == i or est < self._target):
                k, v = items[j]
                est += len(k) + (len(v) if isinstance(v, bytes) else 0) + 8
                j += 1
            yield i, j
            i = j

    def _write_partition_locked(self, items: list, out_level: int
                                ) -> MF.SegmentMeta:
        name = self._manifest.alloc_segment()
        stats = write_sstable(os.path.join(self.dirname, name), items,
                              sync=self._sync == "fsync",
                              bloom_bits_per_key=self._bloom_bits)
        return MF.SegmentMeta(
            name=name, level=out_level, records=stats.n_records,
            bytes=stats.file_bytes,
            min_key=stats.min_key.hex(), max_key=stats.max_key.hex(),
            bloom_k=stats.bloom_k, bloom_bits=stats.bloom_nbits)

    def _advance_compaction_locked(self, st: MF.CompactionState,
                                   budget_left: int | None) -> int:
        """Run one merge until done or out of budget; → bytes written.

        On pause, the completed partitions + resume key go into the
        manifest atomically (``compaction`` field) while the inputs stay
        live — a crash either resumes from exactly here or, if it beat
        the manifest swap, re-merges from the previous pause point and
        the unrecorded partition files are swept as orphans."""
        items = self._merge_inputs_locked(st)
        if st.next_key:
            resume = bytes.fromhex(st.next_key)
            items = [kv for kv in items if kv[0] >= resume]
        spent = 0
        for i, j in self._partition_spans(items):
            meta = self._write_partition_locked(items[i:j], st.out_level)
            st.outputs.append(meta)
            spent += meta.bytes
            if j < len(items) and budget_left is not None \
                    and spent >= budget_left:
                st.next_key = items[j][0].hex()
                self._manifest.compaction = st
                self._count("compact_pause")
                self._store_manifest_locked()
                return spent
        self._finalize_compaction_locked(st)
        return spent

    def _finalize_compaction_locked(self, st: MF.CompactionState) -> None:
        """Publish the merge: outputs become live, inputs are deleted —
        one atomic manifest swap is the commit point."""
        self._count("compact_level")
        names = set(st.inputs)
        keep = [m for m in self._manifest.segments if m.name not in names]
        self._manifest.segments = keep + list(st.outputs)
        self._manifest.compaction = None
        self._store_manifest_locked()
        for name in st.inputs:
            table = self._tables.pop(name, None)
            if table is not None:
                table.close()
            try:
                os.remove(os.path.join(self.dirname, name))
            except FileNotFoundError:
                pass
        for meta in st.outputs:
            self._tables[meta.name] = self._open_table(meta.name)
        self._rebuild_read_order()

    def _maybe_compact_locked(self) -> None:
        """Pay down compaction debt up to the per-wave byte budget:
        resume any paused merge first, then keep servicing triggers
        (L0 count, then byte-capacity overflow shallowest-first) until
        the debt or the budget is exhausted.  Unbudgeted (0), this runs
        every owed merge to completion — each merge still only touches
        its victim + overlap, never the whole store."""
        budget = self._budget
        spent = 0
        while True:
            st = self._manifest.compaction
            if st is None:
                level = self._pick_trigger_locked()
                if level is None:
                    break
                st = self._begin_compaction_locked(level)
                self._manifest.compaction = st  # durable only at a pause
            left = None if budget == 0 else max(1, budget - spent)
            with obs.span("lsm.compact_level", level=st.level,
                          segments=len(st.inputs),
                          resumed=bool(st.next_key)):
                spent += self._advance_compaction_locked(st, left)
            if self._manifest.compaction is not None:
                break                           # paused on budget
            if budget and spent >= budget:
                break
        self.last_compact_bytes = spent

    def _kick_compaction_locked(self) -> None:
        """Compaction admission at a commit/spill boundary: pay the debt
        inline (up to the budget), or — with ``bg_compact`` on — wake
        the daemon worker and return immediately, leaving the debt on
        the ``compact_debt`` gauge for backpressure."""
        if self._bg_thread is not None:
            if self._manifest.compaction is not None \
                    or self._compact_debt_locked() > 0:
                self._bg_wake.set()
        else:
            self._maybe_compact_locked()

    def _bg_loop(self) -> None:
        """Daemon worker: one budget-bounded merge slice per wakeup,
        re-arming itself while debt remains so the lock is released
        between slices (readers and commits interleave).  Any failure —
        IO error or an injected crash firing on this thread — parks in
        ``_bg_exc`` and is re-raised by the next mutation on the caller
        thread (:meth:`_raise_bg`)."""
        while True:
            self._bg_wake.wait()
            self._bg_wake.clear()
            if self._bg_stop.is_set():
                return
            try:
                with self._lock:
                    if self._closed:
                        return
                    self._maybe_compact_locked()
                    more = (self._manifest.compaction is not None
                            or self._compact_debt_locked() > 0)
                if more:
                    self._bg_wake.set()
            except BaseException as e:          # noqa: BLE001 - re-raised
                self._bg_exc = e
                return

    def _stop_bg(self) -> None:
        """Stop + join the worker (idempotent; close() and tests use it;
        the fuzz harness's ``abandon`` calls it too — a dead process has
        no threads)."""
        t = self._bg_thread
        if t is None:
            return
        self._bg_stop.set()
        self._bg_wake.set()
        if t is not threading.current_thread():
            t.join(timeout=10.0)
        self._bg_thread = None

    def compact_debt(self) -> int:
        """Outstanding merge work, in bytes — the backpressure gauge.

        Sums the over-capacity bytes of every level (all of L0 when its
        count trigger is armed) plus the unwritten remainder of a paused
        merge.  0 ⇔ no merge is owed; the serving tier reads this
        through ``QueryEngine.stats`` / ``stats_snapshot()`` as
        ``compact_debt``."""
        with self._lock:
            return self._compact_debt_locked()

    def _compact_debt_locked(self) -> int:
        lb = self._level_bytes()
        counts = self._manifest.level_counts()
        debt = 0
        if counts.get(0, 0) >= self._ratio:
            debt += lb.get(0, 0)
        for level, b in lb.items():
            if level >= 1:
                debt += max(0, b - self._cap_bytes(level))
        st = self._manifest.compaction
        if st is not None:
            names = set(st.inputs)
            in_bytes = sum(m.bytes for m in self._manifest.segments
                           if m.name in names)
            done = sum(o.bytes for o in st.outputs)
            debt += max(0, in_bytes - done)
        return debt

    def _abandon_compaction_locked(self) -> None:
        """Drop a paused merge (major compaction supersedes it): the
        recorded outputs are redundant copies of still-live inputs, so
        deleting them loses nothing."""
        st = self._manifest.compaction
        if st is None:
            return
        self._count("compact_abandon")
        self._manifest.compaction = None
        for meta in st.outputs:
            try:
                os.remove(os.path.join(self.dirname, meta.name))
            except FileNotFoundError:
                pass
        self._store_manifest_locked()

    def compact(self) -> None:
        """**Major** compaction: commit + spill the open tail, abandon
        any paused merge, then merge *every* level into the bottom level
        (partitioned at the segment target), dropping all tombstones
        (the merge covers the whole keyspace).  O(total bytes) — the
        explicit maintenance/benchmark operation; the online trigger
        path (:meth:`commit_epoch` → ``_maybe_compact_locked``) only
        ever merges one victim + overlap at a time."""
        self._raise_bg()
        with self._lock:
            # segments may only ever hold committed records (recovery
            # trusts them unconditionally) — close the open wave first
            if self._wal.pending_bytes() or self._inval_buf:
                self.commit_epoch(self._epoch)
            self._spill_locked()
            self._compact_all_locked()

    def _compact_all_locked(self) -> None:
        """Full merge of all segments into partitions at the bottom."""
        self._abandon_compaction_locked()
        if not self._manifest.segments:
            return
        with obs.span("lsm.compact_major",
                      segments=len(self._manifest.segments)):
            self._compact_all_impl()

    def _compact_all_impl(self) -> None:
        merged: dict[bytes, object] = {}
        for _, seg in reversed(self._read_order):   # oldest version first
            for k, v in seg.iter_all():
                merged[k] = v
        items = sorted((k, v) for k, v in merged.items() if v is not TOMBSTONE)
        out_level = max(1, max(m.level for m in self._manifest.segments))
        old = list(self._manifest.segments)
        outs = [self._write_partition_locked(items[i:j], out_level)
                for i, j in self._partition_spans(items)]
        # a major compact pays off ALL debt: sink the run to the first
        # level whose byte capacity holds it (real bytes are only known
        # post-write; the level lives in the manifest, not the file)
        total = sum(m.bytes for m in outs)
        while total > self._cap_bytes(out_level):
            out_level += 1
        for m in outs:
            m.level = out_level
        self._manifest.segments = outs
        self._store_manifest_locked()
        for meta in old:
            self._tables.pop(meta.name).close()
            try:
                os.remove(os.path.join(self.dirname, meta.name))
            except FileNotFoundError:
                pass
        for meta in outs:
            self._tables[meta.name] = self._open_table(meta.name)
        self._rebuild_read_order()

    def level_counts(self) -> dict[int, int]:
        """→ ``{level: live segment count}`` — the compaction-tree shape
        (tests and the ``wikikv_durable_cold`` benchmark assert on it)."""
        with self._lock:
            return self._manifest.level_counts()

    def set_flat_reads(self, flag: bool) -> None:
        """Toggle the benchmark A/B switch: True probes every segment of
        every level (the pre-partitioned read path) on the same files."""
        with self._lock:
            self._flat_reads = bool(flag)
            self._rebuild_read_order()

    # ------------------------------------------------------------------
    # epoch / invalidation journal (device rehydration contract)
    # ------------------------------------------------------------------
    def journal_invalidation(self, path: str) -> None:
        """Journal one invalidation-bus publish into the WAL (device
        rehydration work list; see module docstring)."""
        with self._lock:
            self._wal.append_inval(path)
            self._inval_buf.append(path)

    def mark_device_epoch(self, epoch: int) -> None:
        """The device tier has applied every dirty path through ``epoch``
        (called inside ``DeviceEngine.refresh`` just before the commit, so
        DEVMARK lands in the same WAL wave as its COMMIT).  Clearing the
        pending list is the real effect; the recorded epoch is kept
        monotone like the commit epoch."""
        with self._lock:
            epoch = max(epoch, self._device_epoch)
            self._wal.append_devmark(epoch)
            self._device_epoch = epoch
            self._pending_inval.clear()
            self._inval_buf.clear()

    def last_epoch(self) -> int:
        """Last committed write epoch (restored across restart)."""
        return self._epoch

    def device_epoch(self) -> int:
        """Epoch the device tier last DEVMARKed as fully applied."""
        return self._device_epoch

    def pending_invalidations(self) -> list[str]:
        """Committed dirty paths the device tier has not applied — the
        rehydration work list (order preserved, duplicates kept: the
        dirty-set consumer dedups)."""
        return list(self._pending_inval)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Clean shutdown: stop the background worker, commit any
        buffered tail so a reopen is byte-identical, then release file
        handles (idempotent).  A paused merge stays paused — its
        manifest state survives and the reopened store resumes it.  A
        parked background failure RE-RAISES here instead of being
        swallowed: the worker may have died mid-merge with in-memory
        level state partially mutated, and a clean close would commit
        and publish from that wounded state.  Raising makes the caller
        treat the store as crashed — reopen recovers from the on-disk
        state, which the merge only ever mutates atomically."""
        if self._closed:
            return
        self._stop_bg()
        self._raise_bg()
        with self._lock:
            if self._wal.pending_bytes() or self._inval_buf:
                self.commit_epoch(self._epoch)
            self._wal.close()
            for seg in self._tables.values():
                seg.close()
            self._closed = True


# ---------------------------------------------------------------------------
# store-level helpers
# ---------------------------------------------------------------------------
def durable_engine_factory(root: str, memtable_limit: int = 4096,
                           sync: str | None = None,
                           level_ratio: int | None = None,
                           bloom_bits: int | None = None,
                           block_cache: BlockCache | None = None,
                           segment_target_bytes: int | None = None,
                           compact_budget_bytes: int | None = None,
                           bg_compact: bool | None = None
                           ) -> Callable[[int], DurableKV]:
    """Engine factory for ``ShardedPathStore``: shard *i* gets its own
    WAL + segment directory ``<root>/shard_<i>`` — per-shard group commit
    and compaction (and, with ``bg_compact``, a per-shard compaction
    worker), the per-shard isolation of the in-memory tier kept on
    disk.  ``block_cache`` (if any) is shared by every shard: one global
    byte budget, hot shards take more of it."""
    def make(i: int) -> DurableKV:
        return DurableKV(os.path.join(root, f"shard_{i:02d}"),
                         memtable_limit=memtable_limit, sync=sync,
                         level_ratio=level_ratio, bloom_bits=bloom_bits,
                         block_cache=block_cache,
                         segment_target_bytes=segment_target_bytes,
                         compact_budget_bytes=compact_budget_bytes,
                         bg_compact=bg_compact)
    return make


STORE_META = "STORE.json"


def open_durable_store(root: str, n_shards: int | None = None,
                       depth_budget: int | None = P.DEFAULT_DEPTH_BUDGET,
                       memtable_limit: int = 4096, sync: str | None = None,
                       level_ratio: int | None = None,
                       bloom_bits: int | None = None,
                       block_cache_bytes: int | None = None,
                       segment_target_bytes: int | None = None,
                       compact_budget_bytes: int | None = None,
                       bg_compact: bool | None = None,
                       shard_workers: int | None = None,
                       commit_pipeline: bool | None = None):
    """Open (or create) a durable path store rooted at ``root``.

    ``n_shards == 1`` → a ``PathStore`` over one ``DurableKV``;
    otherwise a digest-range ``ShardedPathStore`` with one WAL+segment
    directory per shard.  Reopening an existing root recovers from disk
    — zero re-ingestion.  ``level_ratio`` / ``bloom_bits`` /
    ``block_cache_bytes`` / ``segment_target_bytes`` /
    ``compact_budget_bytes`` / ``bg_compact`` / ``shard_workers`` /
    ``commit_pipeline`` default to their ``REPRO_*`` env knobs (see
    docs/STORAGE.md); the block cache is ONE shared LRU across all
    shards, so the byte budget is store-global.

    The shard count is persisted in ``STORE.json`` at creation and
    enforced on reopen: digest-range routing depends on S, so reopening
    with a different count would silently send every lookup to the wrong
    shard.  Pass ``n_shards=None`` to reopen with whatever the store was
    created with."""
    import json
    from ..core.engine import ShardedPathStore
    do_sync = W.sync_mode(sync) == "fsync"
    os.makedirs(root, exist_ok=True)
    cache = default_block_cache(block_cache_bytes)
    meta_path = os.path.join(root, STORE_META)
    if os.path.exists(meta_path):
        with open(meta_path, "r", encoding="utf-8") as f:
            persisted = int(json.load(f)["n_shards"])
        if n_shards is not None and n_shards != persisted:
            raise ValueError(
                f"store at {root!r} was created with n_shards={persisted}, "
                f"cannot reopen with n_shards={n_shards} (digest-range "
                "routing would change)")
        n_shards = persisted
    else:
        n_shards = 1 if n_shards is None else max(1, n_shards)
        tmp = meta_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"n_shards": n_shards}, f)
            if do_sync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, meta_path)
        if do_sync:
            # the shard-count guard is itself part of the durability
            # story: without it a power loss could leave shard data with
            # no STORE.json, letting a wrong-S reopen misroute digests
            W.fsync_dir(root)
    if n_shards <= 1:
        return PathStore(DurableKV(root, memtable_limit=memtable_limit,
                                   sync=sync, level_ratio=level_ratio,
                                   bloom_bits=bloom_bits, block_cache=cache,
                                   segment_target_bytes=segment_target_bytes,
                                   compact_budget_bytes=compact_budget_bytes,
                                   bg_compact=bg_compact),
                         depth_budget=depth_budget)
    return ShardedPathStore(
        n_shards=n_shards,
        engine_factory=durable_engine_factory(
            root, memtable_limit=memtable_limit, sync=sync,
            level_ratio=level_ratio, bloom_bits=bloom_bits,
            block_cache=cache, segment_target_bytes=segment_target_bytes,
            compact_budget_bytes=compact_budget_bytes,
            bg_compact=bg_compact),
        depth_budget=depth_budget, shard_workers=shard_workers,
        commit_pipeline=commit_pipeline)

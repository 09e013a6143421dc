"""Unified batched query-execution layer: PathStore → Hopper kernels.

Port of ``repro/core/engine.py``: the host half (``EngineStats``,
``QueryEngine``, ``ShardedPathStore``, ``HostEngine``, ``BatchPlanner``,
``OpFuture``, ``drive``, ``admit_wave``, ``unlink_wave``) is the
reference's, unchanged; ``DeviceEngine`` holds its epoch views as torch
tensors on its device and calls the port's kernels.

One engine abstraction serves every Q1–Q4 operation of the online tier,
batched (DESIGN goal: the paper's "O(1) storage round trips per query"
realized as "O(1) engine calls per *batch* of queries"):

* ``QueryEngine``   — the batched operator contract.  Every method takes a
  whole batch and counts as ONE round trip regardless of batch size; the
  per-call batch sizes are tracked in ``EngineStats`` so benchmarks can
  report amortization directly.

* ``HostEngine``    — wraps a ``PathStore`` (or the digest-range
  ``ShardedPathStore`` below).  Round trips execute on the host against
  the LSM engine(s); batching amortizes the python/op dispatch overhead
  and gives the planner a single choke point to count.

* ``DeviceEngine``  — wraps a frozen ``TensorWiki``: Q1 point lookups and
  Q4 prefix scans dispatch through ``kernels.ops`` to the CUDA kernels
  (plain PyTorch versions for CPU tensors), Q2 is one batched lookup whose child
  listing derives from the resolved directory record, Q3 flattens the
  whole batch's ancestor chains into one lookup launch, and keyword
  containment runs as a Q1-style lookup into a device token-digest
  table + CSR slice — the inverted index, tensorized.  Record payloads
  live in a host-side row table (the stand-in for device payload rows).

* ``BatchPlanner``  — collects the operations of many concurrent
  navigation sessions into per-operator batches; ``flush()`` executes each
  operator's pending batch in one engine call and resolves the futures.
  This is continuous batching for storage ops, mirroring the serving
  engine's token batching.

* **Online writes** (ISSUE 2) ride the same waves: ``planner.admit/
  update/unlink`` → batched ``admit_many``/``update_many``/``unlink_many``
  round trips through the §IV-C ``WikiWriter`` (CAS + invalidation).  A
  flush runs reads before writes and ``refresh()`` commits between waves,
  so every read wave pins one epoch (staleness Δ = 1 wave); the
  ``DeviceEngine`` refreshes incrementally via ``tensorstore.apply_delta``
  instead of re-freezing.

Parity contract (tested in tests/test_engine.py): for any store state
reachable through the §IV-C write protocol, ``HostEngine`` and
``DeviceEngine`` frozen from the same store return identical results for
every Q1–Q4 batch, including misses and unadvertised orphans.
"""
from __future__ import annotations

import bisect
import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from .. import obs
from . import paths as P
from . import records as R
from .consistency import (CASConflict, InvalidationBus, WikiWriter,
                          attach_journal)
from .executor import CommitSequencer, ShardExecutor, resolve_commit_pipeline
from .store import KVEngine, MemKV, PathStore, _segment_tokens

# operator names used for stats keys
Q1, Q2, Q3, Q4, Q4C = "q1_get", "q2_ls", "q3_navigate", "q4_search", "q4_contains"
# write operators (batched through the same planner/engine round trips)
W_ADMIT, W_UPDATE, W_UNLINK = "w_admit", "w_update", "w_unlink"
# epoch refresh accounting (rows applied per refresh)
REFRESH = "refresh"
READ_OPS = (Q1, Q2, Q3, Q4, Q4C)
WRITE_OPS = (W_ADMIT, W_UPDATE, W_UNLINK)
# durable-tier read-path counters surfaced through QueryEngine.stats
# (``stats.ops[...]`` is the running count; fed by sync_durable_stats)
D_BLOOM_NEG = "d_bloom_neg"     # segment probes skipped by a bloom negative
D_CACHE_HIT = "d_cache_hit"     # block-cache hits on segment point reads
D_CACHE_MISS = "d_cache_miss"   # block-cache misses (block parsed off mmap)
D_SEG_PROBE = "d_seg_probe"     # segments considered per point read (the
                                # partitioned-level acceptance counter)
D_COMPACT_DEBT = "d_compact_debt"   # GAUGE, not a counter: outstanding
                                    # merge bytes — the backpressure signal
D_PIPELINE_DEPTH = "d_commit_pipeline_depth"  # GAUGE: sealed-but-not-durable
                                              # commit waves in flight (0/1)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------
@dataclass
class EngineStats:
    """Per-operator accounting — the amortization evidence.

    ``calls``/``ops``/``max_batch`` count *unique keys per engine call*
    (what the engine actually executed).  ``served``/``max_served`` count
    *logical operations resolved per call* as reported by the planner:
    identical ops from concurrent sessions share one batch slot, so one
    engine call can serve far more lookups than it executes keys."""

    calls: dict[str, int] = field(default_factory=dict)
    ops: dict[str, int] = field(default_factory=dict)
    max_batch: dict[str, int] = field(default_factory=dict)
    served: dict[str, int] = field(default_factory=dict)
    max_served: dict[str, int] = field(default_factory=dict)

    def record(self, op: str, batch: int) -> None:
        if batch <= 0:
            return
        self.calls[op] = self.calls.get(op, 0) + 1
        self.ops[op] = self.ops.get(op, 0) + batch
        self.max_batch[op] = max(self.max_batch.get(op, 0), batch)

    def record_served(self, op: str, n: int) -> None:
        if n <= 0:
            return
        self.served[op] = self.served.get(op, 0) + n
        self.max_served[op] = max(self.max_served.get(op, 0), n)

    def total_calls(self) -> int:
        return sum(self.calls.values())

    def total_ops(self) -> int:
        return sum(self.ops.values())

    def reset(self) -> None:
        for d in (self.calls, self.ops, self.max_batch,
                  self.served, self.max_served):
            d.clear()


# ---------------------------------------------------------------------------
# the batched operator contract
# ---------------------------------------------------------------------------
class QueryEngine:
    """Batched Q1–Q4 execution plus the batched write path.

    One method call == one storage round trip.  Write batches route
    through a ``WikiWriter`` (parent-after-child admission, reverse-order
    unlink, OCC CAS updates, invalidation publishes), so every §IV-C
    guarantee holds for engine-mediated writes too.

    **Epoch contract** — ``epoch`` is a monotone counter of committed
    write generations.  The planner executes a wave's read batches before
    its write batches, and ``refresh()`` (called by the wave driver
    *between* waves) commits visibility.  Upper bound both tiers share:
    a write admitted in wave k is visible to every read of wave k+1
    (Δ = 1 wave).  The lower bound (no read of wave k sees wave-k
    writes) is snapshot-exact on ``DeviceEngine`` — its tensors are
    frozen until ``refresh()``, so even a multi-round wave pins one
    epoch.  ``HostEngine`` reads hit the live store, so the lower bound
    holds per *flush* (round) only: a later round of the same wave may
    already observe an earlier round's admissions.  That is the paper's
    host-tier semantics — Theorem 2 (no partial reads) still holds for
    every interleaving via the write protocol itself, which is what the
    host-side property tests assert.
    """

    def __init__(self):
        self.stats = EngineStats()
        self.epoch = 0
        self.writer: WikiWriter | None = None
        self._pending_writes = 0

    # -- reads -------------------------------------------------------------
    def q1_get(self, paths: Sequence[str]) -> list[Optional[R.Record]]:
        """Point lookup: one record (or None) per path, order-preserving."""
        raise NotImplementedError

    def q2_ls(self, paths: Sequence[str]
              ) -> list[Optional[tuple[R.DirRecord, list[str]]]]:
        """Directory listing: (dir record, sorted child names) per path,
        None where the path is absent or not a directory."""
        raise NotImplementedError

    def q3_navigate(self, paths: Sequence[str]) -> list[list[R.Record]]:
        """Ancestor chain root→leaf per path (empty if the leaf is absent)."""
        raise NotImplementedError

    def q4_search(self, prefixes: Sequence[str],
                  limit: int | None = None) -> list[list[str]]:
        """Prefix scan over the ordered path namespace, ``limit`` per prefix."""
        raise NotImplementedError

    def q4_contains(self, tokens: Sequence[str],
                    limit: int | None = None) -> list[list[str]]:
        """Inverted-index token search: matching paths per token."""
        raise NotImplementedError

    # -- writes ------------------------------------------------------------
    def _require_writer(self) -> WikiWriter:
        if self.writer is None:
            raise RuntimeError(
                f"{type(self).__name__} has no writer attached — "
                "construct it with a backing store to enable writes")
        return self.writer

    def admit_many(self, items: Sequence[tuple[str, R.Record]]
                   ) -> list[R.Record | Exception]:
        """One batched admission round trip.  Items apply parents-first
        (depth order, stable) so a parent and its child admitted in the
        same wave never race the auto-created parent chain.  A per-item
        validation failure (depth budget, malformed path, non-directory
        parent) resolves to the exception instead of poisoning the batch."""
        w = self._require_writer()
        self.stats.record(W_ADMIT, len(items))
        budget = w.store.depth_budget
        out: list[R.Record | Exception] = [rec for _, rec in items]
        order = sorted(range(len(items)), key=lambda i: P.depth(items[i][0]))
        for i in order:
            path, rec = items[i]
            try:
                if P.normalize(path, depth_budget=budget) == P.ROOT:
                    w.put_record(P.ROOT, rec)
                else:
                    w.admit(path, rec)
            except (P.PathError, ValueError) as e:
                out[i] = e
        self._note_writes(len(items))
        return out

    def update_many(self, updates: Sequence[
            tuple[str, Callable[[R.FileRecord], R.FileRecord]]],
            max_retries: int = 8) -> list[R.Record | CASConflict]:
        """One batched OCC round trip: each (path, mutate) runs the
        writer's version-CAS loop; a conflict that exhausts its retries
        resolves to the ``CASConflict`` instance instead of raising, so
        one stale page never poisons the rest of the batch."""
        w = self._require_writer()
        self.stats.record(W_UPDATE, len(updates))
        out: list[R.Record | Exception] = []
        for path, mutate in updates:
            try:
                out.append(w.update_file(path, mutate,
                                         max_retries=max_retries))
            except (CASConflict, KeyError, P.PathError) as e:
                # KeyError: no file record at the path (e.g. unlinked by
                # an earlier run of this same wave) — a per-item outcome,
                # like an exhausted CAS, not a batch failure
                out.append(e)
        self._note_writes(len(updates))
        return out

    def unlink_many(self, paths: Sequence[str]
                    ) -> list[bool | P.PathError]:
        """One batched unlink round trip, deepest-first so a subtree and
        its root unlinked in the same wave stay parent-link-consistent.
        Returns, per path, whether a record existed; an invalid unlink
        (the root — it has no parent to unlink from) resolves to the
        ``PathError`` instead of poisoning the batch."""
        w = self._require_writer()
        self.stats.record(W_UNLINK, len(paths))
        out: list[bool | P.PathError] = [False] * len(paths)
        order = sorted(range(len(paths)), key=lambda i: -P.depth(paths[i]))
        for i in order:
            try:
                out[i] = w.get(paths[i]) is not None
                w.unlink(paths[i])
            except P.PathError as e:
                out[i] = e
        self._note_writes(len(paths))
        return out

    # -- epoch refresh -----------------------------------------------------
    def _note_writes(self, n: int) -> None:
        if n > 0:
            self._pending_writes += n

    def _backing_store(self):
        store = getattr(self, "store", None)
        if store is None and self.writer is not None:
            store = self.writer.store
        return store

    def _restore_epoch(self) -> None:
        """Rehydrate the epoch counter from a durable store's last WAL
        commit (0 on volatile stores) — called at construction so an
        engine reopened over an existing directory resumes the committed
        epoch sequence instead of restarting at 0."""
        store = self._backing_store()
        last = getattr(store, "last_epoch", None)
        if last is not None:
            self.epoch = last()

    def _commit_durable(self) -> None:
        """Group-commit the wave at the (just bumped) epoch: one WAL
        flush per planner wave on a durable store, so WAL batch
        boundaries align with epoch boundaries.  No-op on volatile
        stores."""
        store = self._backing_store()
        commit = getattr(store, "commit_epoch", None)
        if commit is not None:
            commit(self.epoch)

    def refresh(self, force: bool = False) -> int:
        """Commit admitted writes to the read view and return the new
        epoch.  Called by wave drivers between waves; a no-op (same
        epoch) when nothing was written since the last refresh.
        ``force`` overrides a DeviceEngine refresh cadence > 1 — drain
        paths (snapshot, shutdown) use it to guarantee full visibility."""
        if self._pending_writes:
            self._pending_writes = 0
            self.epoch += 1
            self._commit_durable()
        return self.epoch


# ---------------------------------------------------------------------------
# digest-range sharded host store
# ---------------------------------------------------------------------------
class ShardedPathStore:
    """``PathStore`` facade sharded by digest range across S shards.

    Shard s owns the digest interval [s·2⁶⁴/S, (s+1)·2⁶⁴/S): point ops
    route by ``H(π)``; namespace scans (Q4 prefix / token index) fan out to
    every shard and merge in path order.  Each shard runs its own
    ``MemKV`` — private memtable, private runs, private compaction — so
    write pressure on one digest range never stalls reads on another
    (the per-shard memtable/compaction isolation of a real LSM fleet).

    Duck-types the ``PathStore`` surface used by the writer, cache,
    tensorstore freeze and engines.

    ``engine_factory`` (shard index → ``KVEngine``) is how the durable
    tier plugs in: ``storage.durable_engine_factory(root)`` gives every
    digest-range shard its own WAL + segment directory, so group commit,
    spill and compaction stay per-shard on disk exactly as the memtables
    are in memory.

    **Fan-out execution** (ISSUE 10): every multi-shard operation routes
    through one :class:`~repro.core.executor.ShardExecutor` —
    ``shard_workers`` (None → ``REPRO_SHARD_WORKERS``, default 0) picks
    serial loops (bit-identical to the pre-executor behavior) or a
    thread pool, so wave latency is the *max* of per-shard work, not the
    sum.  ``commit_pipeline`` (None → ``REPRO_COMMIT_PIPELINE``) makes
    durable group commits depth-1 pipelined: wave e's per-shard WAL
    fsyncs run concurrently on a commit sequencer while wave e+1
    computes; :meth:`durable_epoch` advertises only landed fsyncs.
    """

    def __init__(self, n_shards: int = 4,
                 engines: Sequence[KVEngine] | None = None,
                 depth_budget: int | None = P.DEFAULT_DEPTH_BUDGET,
                 memtable_limit: int = 4096,
                 engine_factory: Callable[[int], KVEngine] | None = None,
                 executor: ShardExecutor | None = None,
                 shard_workers: int | None = None,
                 commit_pipeline: bool | None = None):
        if engines is not None:
            self.shards = [PathStore(e, depth_budget=depth_budget)
                           for e in engines]
        elif engine_factory is not None:
            self.shards = [PathStore(engine_factory(i),
                                     depth_budget=depth_budget)
                           for i in range(max(1, n_shards))]
        else:
            self.shards = [PathStore(MemKV(memtable_limit=memtable_limit),
                                     depth_budget=depth_budget)
                           for _ in range(max(1, n_shards))]
        self.depth_budget = depth_budget
        self._own_executor = executor is None
        self.executor = executor if executor is not None \
            else ShardExecutor(workers=shard_workers)
        self._pipeline = resolve_commit_pipeline(commit_pipeline)
        self._sequencer: CommitSequencer | None = None

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_of(self, path: str) -> int:
        """Digest-range routing: floor(H(π) / 2⁶⁴ · S)."""
        return (P.path_hash(path) * len(self.shards)) >> 64

    def _route(self, path: str) -> tuple[PathStore, str]:
        p = P.normalize(path, depth_budget=self.depth_budget)
        return self.shards[self.shard_of(p)], p

    # -- writes -------------------------------------------------------------
    def put_record(self, path: str, rec: R.Record) -> None:
        shard, p = self._route(path)
        shard.put_record(p, rec)

    def delete_record(self, path: str) -> None:
        shard, p = self._route(path)
        shard.delete_record(p)

    # -- Q1–Q4 (unbatched PathStore surface) --------------------------------
    def get(self, path: str) -> Optional[R.Record]:
        shard, p = self._route(path)
        return shard.get(p)

    def ls(self, path: str) -> Optional[tuple[R.DirRecord, list[str]]]:
        shard, p = self._route(path)
        return shard.ls(p)

    def navigate(self, path: str) -> list[R.Record]:
        p = P.normalize(path, depth_budget=self.depth_budget)
        out: list[R.Record] = []
        for anc in list(P.ancestors(p)) + [p]:
            rec = self.get(anc)
            if rec is None:
                break
            out.append(rec)
        return out

    # -- batched point fan-outs (one scatter task per owning shard) ---------
    def _fan_out_points(self, paths: Sequence[str], per_shard, serial_one):
        """Route a batch of paths: normalize once, group by owning shard,
        ONE executor task per shard, results re-assembled in input order.
        Serial mode short-circuits to the literal per-path loop so the
        call order (and thus op-counter/engine state) is bit-identical
        to the unbatched facade."""
        if self.executor.workers == 0 or len(paths) <= 1:
            return [serial_one(p) for p in paths]
        by_shard: dict[int, list[tuple[int, str]]] = {}
        for i, raw in enumerate(paths):
            p = P.normalize(raw, depth_budget=self.depth_budget)
            by_shard.setdefault(self.shard_of(p), []).append((i, p))
        groups = sorted(by_shard.items())

        def run(_, group):
            si, pairs = group
            return per_shard(self.shards[si], [p for _, p in pairs])

        out = [None] * len(paths)
        for (_, pairs), res in zip(groups,
                                   self.executor.scatter(run, groups)):
            for (i, _), v in zip(pairs, res):
                out[i] = v
        return out

    def get_many(self, paths: Sequence[str]) -> list[Optional[R.Record]]:
        """Batched Q1: ``[self.get(p) for p in paths]``, fanned out as
        one task per owning shard when the executor has workers."""
        return self._fan_out_points(
            paths, lambda shard, ps: [shard.get(p) for p in ps], self.get)

    def ls_many(self, paths: Sequence[str]
                ) -> list[Optional[tuple[R.DirRecord, list[str]]]]:
        """Batched Q2 (same fan-out shape as :meth:`get_many`)."""
        return self._fan_out_points(
            paths, lambda shard, ps: [shard.ls(p) for p in ps], self.ls)

    def navigate_many(self, paths: Sequence[str]) -> list[list[R.Record]]:
        """Batched Q3: flatten every ancestor chain into ONE batched get
        fan-out, then truncate each chain at its first miss — the same
        flatten-then-truncate shape the device engine uses."""
        if self.executor.workers == 0 or len(paths) <= 1:
            return [self.navigate(p) for p in paths]
        norm = [P.normalize(p, depth_budget=self.depth_budget)
                for p in paths]
        chains = [list(P.ancestors(p)) + [p] for p in norm]
        recs = self.get_many([a for chain in chains for a in chain])
        out: list[list[R.Record]] = []
        i = 0
        for chain in chains:
            hit: list[R.Record] = []
            alive = True
            for _ in chain:
                rec = recs[i]
                i += 1
                if alive and rec is not None:
                    hit.append(rec)
                else:
                    alive = False
            out.append(hit)
        return out

    # -- namespace fan-outs (scatter + ordered k-way merge) -----------------
    def _scatter(self, fn: Callable[[int, PathStore], object]) -> list:
        """Fan one callable out across every shard via the executor
        (serial loop in shard order when ``workers == 0``)."""
        return self.executor.scatter(fn, self.shards)

    def search(self, prefix: str, limit: int | None = None) -> list[str]:
        # per-shard results are already in path order, so the global first
        # `limit` paths are contained in the union of per-shard first
        # `limit` — fan out WITH the limit, then k-way merge (O(n log k),
        # the shards are sorted runs) + truncate
        per = self._scatter(lambda i, s: s.search(prefix, limit=limit))
        merged = list(heapq.merge(*per))
        return merged if limit is None else merged[:limit]

    def search_contains(self, token: str, limit: int | None = None) -> list[str]:
        per = self._scatter(
            lambda i, s: s.search_contains(token, limit=limit))
        merged = list(heapq.merge(*per))
        return merged if limit is None else merged[:limit]

    # -- namespace / maintenance -------------------------------------------
    def all_paths(self) -> list[str]:
        return list(heapq.merge(*self._scatter(lambda i, s: s.all_paths())))

    def count(self) -> int:
        return sum(self._scatter(lambda i, s: s.count()))

    def flush(self) -> None:
        self._drain_pipeline()
        self._scatter(lambda i, s: s.flush())

    def compact(self) -> None:
        self._drain_pipeline()
        self._scatter(lambda i, s: s.compact())

    def op_counts(self) -> dict[str, int]:
        total: dict[str, int] = {}
        for s in self.shards:
            for k, v in s.engine.op_counts().items():
                total[k] = total.get(k, 0) + v
        return total

    # -- durable-tier fan-out (see PathStore for the single-shard forms) ----
    @property
    def durable(self) -> bool:
        return any(s.durable for s in self.shards)

    def close(self) -> None:
        """Drain the commit pipeline, close every shard, then release
        the execution resources this store owns."""
        try:
            self._drain_pipeline()
        finally:
            self._scatter(lambda i, s: s.close())
            if self._sequencer is not None:
                self._sequencer.close()
                self._sequencer = None
            if self._own_executor:
                self.executor.close()

    def commit_epoch(self, epoch: int) -> None:
        """Fan the group commit out across shards.  Pipelined (durable
        stores with ``commit_pipeline`` on): join wave e-1's in-flight
        fsync, seal every shard synchronously, hand the durability work
        to the sequencer and return — wave e's fsync overlaps the
        caller's next wave.  Otherwise: scatter synchronous per-shard
        commits (concurrent per-shard fsyncs when the executor has
        workers, the serial loop when not)."""
        if self._pipeline and self.durable:
            self._commit_pipelined(epoch)
        else:
            self._scatter(lambda i, s: s.commit_epoch(epoch))

    def _commit_pipelined(self, epoch: int) -> None:
        seq = self._sequencer
        if seq is None:
            seq = self._sequencer = CommitSequencer(
                self.executor, durable_epoch=self.last_epoch())
        seq.wait()                      # depth 1: join wave e-1 first
        completes = [c for c in (s.seal_commit(epoch) for s in self.shards)
                     if c is not None]
        seq.submit(epoch, completes)

    def _drain_pipeline(self) -> None:
        """Join any sealed-but-not-durable wave.  Every path that writes
        segment files or reads WAL durability state directly (flush,
        compact, close) must drain first, or its own WAL commit could
        overtake the sealed wave's bytes."""
        if self._sequencer is not None:
            self._sequencer.wait()

    def durable_epoch(self) -> int:
        """The advertised durable epoch: the newest epoch whose WAL
        fsync has LANDED on every shard.  Trails :meth:`last_epoch` by
        at most the one in-flight pipelined wave; equal to it whenever
        the pipeline is off or drained."""
        if self._sequencer is not None:
            return self._sequencer.durable_epoch()
        return self.last_epoch()

    def commit_pipeline_depth(self) -> int:
        """Sealed-but-not-yet-durable waves in flight (0 or 1)."""
        return 0 if self._sequencer is None else self._sequencer.depth()

    def compact_debt(self) -> int | None:
        """Fleet-wide outstanding merge bytes (None if no shard is
        durable): one shard's backlog is enough to raise backpressure,
        so the shards sum rather than average."""
        debts = [d for d in self._scatter(lambda i, s: s.compact_debt())
                 if d is not None]
        return sum(debts) if debts else None

    def last_epoch(self) -> int:
        return max((s.last_epoch() for s in self.shards), default=0)

    def journal_invalidation(self, path: str) -> None:
        """Journal into the owning shard's WAL — the publish is recovered
        by the shard that also holds the record bytes."""
        shard, p = self._route(path)
        shard.journal_invalidation(p)

    def mark_device_epoch(self, epoch: int) -> None:
        self._scatter(lambda i, s: s.mark_device_epoch(epoch))

    def pending_invalidations(self) -> list[str]:
        out: list[str] = []
        for res in self._scatter(lambda i, s: s.pending_invalidations()):
            out.extend(res)
        return out


# ---------------------------------------------------------------------------
# host engine
# ---------------------------------------------------------------------------
class HostEngine(QueryEngine):
    """Batched operators over a (possibly sharded) host PathStore.

    Writes route through a ``WikiWriter`` over the same store; pass an
    existing writer (or bus) to share its invalidation stream with other
    tiers (cache, device mirror).  ``refresh()`` drains the bus, so cache
    invalidations are delivered at wave cadence — the same Δ = 1 wave
    bound the device engine gives its tensor mirror."""

    def __init__(self, store: "PathStore | ShardedPathStore",
                 writer: WikiWriter | None = None,
                 bus: InvalidationBus | None = None):
        super().__init__()
        self.store = store
        self.writer = writer if writer is not None else WikiWriter(store, bus=bus)
        # NOTE: no attach_journal here — the WAL invalidation journal
        # exists solely for device-tier rehydration, and only a
        # DeviceEngine (whose refresh DEVMARKs clear it) may attach it;
        # a host-only attach would grow the pending list forever
        self._restore_epoch()

    @property
    def store(self) -> "PathStore | ShardedPathStore":
        return self._store

    @store.setter
    def store(self, store: "PathStore | ShardedPathStore") -> None:
        """(Re)attach the backing store.  The durable-counter high-water
        marks reset with it: a swapped-in store (``ServingEngine.
        reopen_store`` and friends) restarts its op counters at 0, so
        stale marks from the previous store would silently drop its
        telemetry until the new counts re-passed the old highs."""
        self._store = store
        self._durable_seen: dict[str, int] = {}

    def refresh(self, force: bool = False) -> int:
        """Drain the invalidation bus, commit the wave (see base class),
        and fold the durable tier's read-path counters into ``stats``."""
        with obs.span("host.refresh"):
            if self.writer.bus is not None:
                self.writer.bus.drain()
            out = super().refresh(force)
            self.sync_durable_stats()
        return out

    #: (engine-level op counter, stats key) pairs mirrored by
    #: :meth:`sync_durable_stats` — the DurableKV read-path telemetry
    _DURABLE_COUNTERS = (("bloom_neg", D_BLOOM_NEG),
                         ("cache_hit", D_CACHE_HIT),
                         ("cache_miss", D_CACHE_MISS),
                         ("seg_probe", D_SEG_PROBE))

    def sync_durable_stats(self) -> None:
        """Surface the durable tier's read-path counters through
        ``self.stats`` (delta'd, so repeated calls never double-count).

        ``stats.ops[D_BLOOM_NEG]`` then reads as "segment probes skipped
        by a bloom negative so far", ``stats.ops[D_CACHE_HIT]`` /
        ``[D_CACHE_MISS]`` as block-cache accounting, and
        ``stats.ops[D_SEG_PROBE]`` as "segments considered across all
        point reads" — the counter that proves partitioned levels probe
        exactly one segment per level — summed across shards on a
        ``ShardedPathStore``.  ``stats.ops[D_COMPACT_DEBT]`` is a gauge
        (assigned, not accumulated): the store's current outstanding
        merge bytes, the compaction backpressure signal.  Called
        automatically at every ``refresh()``; benchmarks/tests call it
        directly after a read-only burst (reads never trigger a
        refresh).  No-op over volatile stores (MemKV counts none of
        these)."""
        oc = getattr(self.store, "op_counts", None)
        if oc is None:
            return
        counts = oc()
        for src, dst in self._DURABLE_COUNTERS:
            cur = counts.get(src, 0)
            prev = self._durable_seen.get(src, 0)
            if cur > prev:
                self.stats.record(dst, cur - prev)
                self._durable_seen[src] = cur
        debt_fn = getattr(self.store, "compact_debt", None)
        debt = debt_fn() if debt_fn is not None else None
        if debt is not None:
            self.stats.ops[D_COMPACT_DEBT] = debt
            obs.gauge("lsm.compact_debt").set(debt)
        depth_fn = getattr(self.store, "commit_pipeline_depth", None)
        if depth_fn is not None:
            self.stats.ops[D_PIPELINE_DEPTH] = depth_fn()

    def q1_get(self, paths):
        self.stats.record(Q1, len(paths))
        with obs.span("host.q1_get"):
            batched = getattr(self.store, "get_many", None)
            if batched is not None:
                return batched(paths)
            return [self.store.get(p) for p in paths]

    def q2_ls(self, paths):
        self.stats.record(Q2, len(paths))
        with obs.span("host.q2_ls"):
            batched = getattr(self.store, "ls_many", None)
            if batched is not None:
                return batched(paths)
            return [self.store.ls(p) for p in paths]

    def q3_navigate(self, paths):
        self.stats.record(Q3, len(paths))
        with obs.span("host.q3_navigate"):
            batched = getattr(self.store, "navigate_many", None)
            if batched is not None:
                return batched(paths)
            return [self.store.navigate(p) for p in paths]

    def q4_search(self, prefixes, limit=None):
        self.stats.record(Q4, len(prefixes))
        with obs.span("host.q4_search"):
            return [self.store.search(p, limit=limit) for p in prefixes]

    def q4_contains(self, tokens, limit=None):
        self.stats.record(Q4C, len(tokens))
        with obs.span("host.q4_contains"):
            return [self.store.search_contains(t, limit=limit) for t in tokens]


# ---------------------------------------------------------------------------
# device engine
# ---------------------------------------------------------------------------
def _token_hash(token: str) -> int:
    """FNV-1a of the token bytes — the same digest function as the path
    keys (``paths.path_hash`` hashes raw UTF-8 without normalizing, and
    tokens never contain '/', so the namespaces cannot collide)."""
    return P.path_hash(token)


class _EpochView:
    """One epoch's immutable device-side state — the read buffer of the
    double-buffered swap.

    Every read method captures ``st = self._st`` exactly once, so an
    in-flight batch keeps reading epoch e even if ``refresh()`` installs
    e+1 concurrently: installing is a single reference assignment, and no
    field of an installed view is ever written again (patch refreshes
    build the successor with ``clone()`` + ``index_copy_`` / fresh overlay
    dicts, never in-place writes to the previous view's tensors).

    ``keys`` is the padded sorted digest view as one int64 per key
    (``kernels.ops.key64``), ``pinned`` the (pin_keys, pin_pos) staging
    pair, ``tok_keys`` the token-digest table; all are torch tensors on
    the engine's device, as is ``ptoks``.
    """

    __slots__ = ("wiki", "records", "paths", "keys", "view_rows",
                 "ptoks", "pinned", "tok_keys", "tok_offsets",
                 "tok_rows", "tok_patch", "tok_extra")


class DeviceEngine(QueryEngine):
    """Batched operators over the epoch-versioned tensor index, on a torch
    device (``cuda`` unless the caller passes ``device="cpu"``).

    Q1/Q3/keyword routing run through ``kernels.ops.path_lookup`` (the
    CUDA kernel on the card, the plain binary search on the CPU); Q4
    prefix scans run through ``kernels.ops.prefix_search``.  Record
    payloads are resolved from a host-side row table — the row id IS the
    payload pointer, so the device op does all the addressing work.

    **Incremental refresh** — when constructed over a backing store, the
    engine's writes (and any other writer sharing its ``InvalidationBus``)
    accumulate as dirty-path invalidations.  ``refresh()`` drains the bus,
    materializes ONE ``TensorDelta`` (O(|dirty|) point gets), applies it
    via ``tensorstore.apply_delta_ex`` and bumps ``epoch``.  Small deltas
    take the **patch** path (the touched token rows are copied into a
    clone of the previous epoch's token matrix; every other device tensor
    of the previous epoch is reused); large ones rebuild.

    **Double-buffered epoch swap** — all derived read state lives in one
    immutable ``_EpochView``; ``refresh()`` constructs epoch e+1's view
    off to the side and installs it with a single reference assignment.

    **Refresh cadence** — ``refresh_cadence=k`` commits only every k-th
    refresh request (``force=True`` overrides); ``refresh_mode`` pins
    ``apply_delta_ex``'s mode.

    The pinned hot set ("/" + dimensions) is staged per epoch as
    (key, sorted-view position) pairs for the kernel's level-0 probe —
    see kernels/path_lookup.py.
    """

    #: refresh history retained for diagnostics/benchmarks
    DELTA_LOG_KEEP = 16

    def __init__(self, wiki, records: list[Optional[R.Record]],
                 depth_budget: int | None = P.DEFAULT_DEPTH_BUDGET,
                 store: "PathStore | ShardedPathStore | None" = None,
                 writer: WikiWriter | None = None,
                 bus: InvalidationBus | None = None,
                 refresh_cadence: int = 1,
                 refresh_mode: str = "auto",
                 device=None):
        super().__init__()
        from ..device import resolve_device
        self.device = resolve_device(device)
        self.depth_budget = depth_budget
        self.store = store
        self.delta_log: list = []
        self.refresh_cadence = max(1, int(refresh_cadence))
        self.refresh_mode = refresh_mode
        #: how the last committed refresh was applied ("materialize" |
        #: "patch" | "rebuild") — benchmarks assert the mode they measure
        self.last_refresh_kind = "materialize"
        self._deferred_waves = 0
        self._dirty: set[str] = set()
        #: dirty paths rehydrated from the durable tier's committed
        #: invalidation journal at construction (diagnostics/tests)
        self.rehydrated_paths: list[str] = []
        if store is not None:
            if writer is not None:
                self.writer = writer
                if self.writer.bus is None:
                    self.writer.bus = bus if bus is not None else InvalidationBus()
            else:
                self.writer = WikiWriter(
                    store, bus=bus if bus is not None else InvalidationBus())
            self.writer.bus.subscribe(self._note_dirty)
            attach_journal(self.writer.bus, store)
            self._restore_epoch()
        self._install(wiki, records)

    def _note_dirty(self, ev) -> None:
        self._dirty.add(ev.path)

    # -- epoch views ---------------------------------------------------
    @property
    def wiki(self):
        return self._st.wiki

    @property
    def records(self) -> list[Optional[R.Record]]:
        return self._st.records

    def epoch_view(self) -> _EpochView:
        """The current epoch's immutable snapshot (tests/benchmarks pin
        it the same way reads do: capture once, use throughout)."""
        return self._st

    def _to_device(self, a: np.ndarray):
        import torch
        return torch.from_numpy(a).to(self.device)

    def _key_tensor(self, hi: np.ndarray, lo: np.ndarray):
        from ..kernels.ops import key64
        return self._to_device(key64(hi, lo))

    def _install(self, wiki, records: list[Optional[R.Record]]) -> None:
        """Full (re)build of every derived device structure for a fresh
        materialized/rebuilt snapshot.  Called at construction and per
        committed rebuild refresh; patch refreshes take ``_patch_install``
        (O(|Δ|)) instead."""
        from ..kernels.ops import pad_keys
        st = _EpochView()
        st.wiki = wiki
        st.records = records
        st.paths = wiki.paths
        # pad the digest view to the lookup tile, as the reference does
        khi_v, klo_v, view_rows = wiki.search_view()
        st.keys = self._key_tensor(*pad_keys(np.asarray(khi_v), np.asarray(klo_v)))
        st.view_rows = np.asarray(view_rows)
        # explicit copy: on the CPU torch.from_numpy aliases the array,
        # and the patch path mutates wiki.path_tokens in place — the epoch
        # view's tensor must not alias the mutable master
        st.ptoks = self._to_device(np.array(wiki.path_tokens))
        st.pinned = self._stage_pinned(wiki, khi_v, klo_v)
        self._max_path_bytes = int(wiki.path_tokens.shape[1])
        # device token-digest table: sorted FNV digests of every segment
        # token + CSR of matching path rows (rows pre-sorted by path bytes,
        # the same order the host token-index scan yields).  The master
        # token map lives on the engine so patches can maintain it; the
        # packed arrays live on the view and are immutable per epoch.
        tok_map: dict[str, list[int]] = {}
        for path, row in wiki.row_of.items():
            for tok in _segment_tokens(path):
                tok_map.setdefault(tok, []).append(row)
        for rows in tok_map.values():
            rows.sort(key=lambda r: wiki.paths[r])
        self._tok_map = tok_map
        toks = sorted(tok_map, key=_token_hash)
        self._tok_idx = {t: i for i, t in enumerate(toks)}
        tdig = np.array([_token_hash(t) for t in toks], dtype=np.uint64)
        t_off = np.zeros((len(toks) + 1,), dtype=np.int32)
        t_rows: list[int] = []
        for i, t in enumerate(toks):
            t_rows.extend(tok_map[t])
            t_off[i + 1] = len(t_rows)
        st.tok_keys = self._key_tensor(*pad_keys(
            (tdig >> np.uint64(32)).astype(np.uint32),
            (tdig & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
        st.tok_offsets = t_off
        st.tok_rows = np.asarray(t_rows, dtype=np.int32)
        st.tok_patch = {}
        st.tok_extra = {}
        self._publish(st)
        self.last_refresh_kind = wiki.refresh_kind

    def _publish(self, st: _EpochView) -> None:
        """Install ``st`` as the current epoch view.  On a card its
        tensors were written on this thread's current stream, and a reader
        on another stream must not launch on them before those writes
        land, so the stream is synchronised before the swap."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.current_stream(self.device).synchronize()
        self._st = st          # the swap: one assignment, atomic in python

    def _stage_pinned(self, wiki, khi_view: np.ndarray, klo_view: np.ndarray):
        """Stage the pinned hot set ("/" + every dimension — the paper's
        L1 tier) for the kernel's level-0 probe: (key, position) where
        position is the row's rank in the sorted search view — the value
        the table search would produce."""
        from ..kernels.ops import pad_pinned
        prow = wiki.pinned_rows()
        phi = np.asarray(wiki.keys_hi[prow])
        plo = np.asarray(wiki.keys_lo[prow])
        k64 = (khi_view.astype(np.uint64) << np.uint64(32)) | klo_view.astype(np.uint64)
        p64 = (phi.astype(np.uint64) << np.uint64(32)) | plo.astype(np.uint64)
        pos = np.searchsorted(k64, p64).astype(np.int32)
        phi_p, plo_p, pos_p = pad_pinned(phi, plo, pos)
        return (self._key_tensor(phi_p, plo_p), self._to_device(pos_p))

    def _patch_install(self, prev: _EpochView, wiki,
                       records: list[Optional[R.Record]], info) -> None:
        """O(|Δ|) successor view for an in-place patch refresh: reuse the
        previous epoch's device tensors wherever the patch left them
        valid, build the rest anew.  Epoch e's tensors are never written —
        the token matrix is ``clone()``d before ``index_copy_`` writes the
        touched rows, and overlay dicts are copied — so readers holding e
        keep a consistent view through the swap."""
        from ..kernels.ops import pad_keys
        st = _EpochView()
        st.wiki = wiki
        st.records = records
        st.paths = wiki.paths
        if info.keys_changed:
            khi_v, klo_v, view_rows = wiki.search_view()
            st.keys = self._key_tensor(*pad_keys(np.asarray(khi_v), np.asarray(klo_v)))
            st.view_rows = np.asarray(view_rows)
            # any membership change shifts sorted-view ranks → restage
            st.pinned = self._stage_pinned(wiki, khi_v, klo_v)
        else:
            st.keys = prev.keys
            st.view_rows = prev.view_rows
            st.pinned = prev.pinned
        touched = list(info.new_rows) + list(info.removed_rows)
        if touched:
            idx = np.asarray(touched, dtype=np.int64)
            st.ptoks = prev.ptoks.clone().index_copy_(
                0, self._to_device(idx), self._to_device(wiki.path_tokens[idx]))
        else:
            st.ptoks = prev.ptoks
        # token table: the packed base (digests + CSR) is immutable; rows
        # of changed tokens move to copy-on-write overlays, folded back
        # into the base at the next rebuild.  The engine-level master map
        # is maintained incrementally (prev's view never reads it).
        st.tok_keys = prev.tok_keys
        st.tok_offsets, st.tok_rows = prev.tok_offsets, prev.tok_rows
        tok_patch = dict(prev.tok_patch)
        tok_extra = dict(prev.tok_extra)

        def _overlay(tok: str) -> None:
            rows = tuple(self._tok_map.get(tok) or ())
            i = self._tok_idx.get(tok)
            if i is not None:
                tok_patch[i] = rows
            else:
                tok_extra[tok] = rows

        for row, path in zip(info.removed_rows, info.removed_paths):
            for tok in _segment_tokens(path):
                lst = self._tok_map.get(tok)
                if lst is not None and row in lst:
                    lst.remove(row)
                _overlay(tok)
        for row, path in zip(info.new_rows, info.new_paths):
            for tok in _segment_tokens(path):
                lst = self._tok_map.setdefault(tok, [])
                bisect.insort(lst, row, key=wiki.paths.__getitem__)
                _overlay(tok)
        st.tok_patch = tok_patch
        st.tok_extra = tok_extra
        self._publish(st)
        self.last_refresh_kind = "patch"

    # ------------------------------------------------------------------
    @classmethod
    def from_store(cls, store: "PathStore | ShardedPathStore",
                   writer: WikiWriter | None = None,
                   bus: InvalidationBus | None = None, *,
                   refresh_cadence: int = 1,
                   refresh_mode: str = "auto",
                   device=None) -> "DeviceEngine":
        """Freeze the store into the device layout + host payload table
        (the offline pipeline's snapshot step) — one store pass.  The
        engine stays attached to the store: subsequent writes flow
        through its writer and land in the tensor index via incremental
        ``refresh()`` deltas, never another full freeze.  ``device=None``
        means ``cuda`` and raises when no card is visible."""
        from ..device import resolve_device
        from . import tensorstore as TS
        dev = resolve_device(device)
        wiki, recs = TS.freeze_with_records(store)
        eng = cls(wiki, recs, depth_budget=store.depth_budget,
                  store=store, writer=writer, bus=bus,
                  refresh_cadence=refresh_cadence, refresh_mode=refresh_mode,
                  device=dev)
        # Epoch-consistent rehydration over a durable store: the freeze
        # just read the *current* store, which already includes every
        # committed-but-unapplied dirty path in the WAL journal — record
        # them and mark the journal applied through the restored epoch.
        pending = getattr(store, "pending_invalidations", None)
        if pending is not None:
            eng.rehydrated_paths = pending()
            mark = getattr(store, "mark_device_epoch", None)
            if mark is not None and getattr(store, "durable", False):
                mark(eng.epoch)
        return eng

    # ------------------------------------------------------------------
    def refresh(self, force: bool = False) -> int:
        """Apply all writes since the last refresh as one ``TensorDelta``.

        Storage cost is O(|dirty paths|) point gets; applying the delta is
        pure in-memory host work with zero store round trips (contrast
        ``from_store``: a full namespace scan + N gets).  Small deltas
        patch the resident snapshot in place (O(|Δ|) — stable row ids,
        device buffers reused); compaction-triggering ones rebuild.
        No-op when the bus is clean.

        With ``refresh_cadence=k > 1``, only every k-th dirty refresh
        request commits (the deferral counter only advances while writes
        are pending, so idle waves don't consume the cadence); the
        durable group commit rides the committed refresh, so both
        visibility and durability arrive within k waves of the admitting
        wave.  ``force=True`` (snapshot/shutdown drains) commits
        immediately."""
        if self.writer is not None and self.writer.bus is not None:
            self.writer.bus.drain()
        if not self._dirty:
            return self.epoch
        self._deferred_waves += 1
        if not force and self._deferred_waves < self.refresh_cadence:
            return self.epoch
        self._deferred_waves = 0
        from . import tensorstore as TS
        with obs.span("device.refresh", dirty=len(self._dirty)) as sp:
            with obs.span("device.refresh.delta"):
                resident = self.wiki.row_of
                upserts: list[tuple[str, R.Record]] = []
                unlinks: list[str] = []
                for p in sorted(self._dirty):
                    rec = self.store.get(p)
                    if rec is not None:
                        upserts.append((p, rec))
                    elif p in resident:
                        unlinks.append(p)
                self._dirty.clear()
            had_writes = self._pending_writes > 0
            self._pending_writes = 0
            if not upserts and not unlinks:
                # no visible tensor change, but the wave's WAL records
                # (e.g. an admit+unlink that cancelled out) still need
                # their commit
                if had_writes:
                    self._commit_durable()
                return self.epoch
            delta = TS.TensorDelta(epoch=self.epoch + 1,
                                   upserts=upserts, unlinks=unlinks)
            prev = self._st
            t_apply = time.perf_counter() if obs.enabled() else 0.0
            with obs.span("device.refresh.apply", rows=len(delta)):
                wiki, recs, info = TS.apply_delta_ex(
                    self.wiki, self.records, delta, mode=self.refresh_mode)
                if info.kind == "patch":
                    self._patch_install(prev, wiki, recs, info)
                else:
                    self._install(wiki, recs)
            if t_apply:
                # patch-vs-rebuild cost curves, separately addressable
                obs.histogram(f"device.refresh.{info.kind}").record(
                    (time.perf_counter() - t_apply) * 1e3)
            sp.set(kind=info.kind, epoch=self.epoch + 1)
            self.delta_log.append(delta)
            del self.delta_log[:-self.DELTA_LOG_KEEP]
            self.epoch += 1
            self.stats.record(REFRESH, len(delta))
            self.stats.record(f"{REFRESH}_{info.kind}", len(delta))
            obs.set_context(epoch=self.epoch)
            # durable wave boundary: DEVMARK (journal applied through this
            # epoch) rides the same WAL commit as the wave it closes
            mark = getattr(self.store, "mark_device_epoch", None)
            if mark is not None and getattr(self.store, "durable", False):
                mark(self.epoch)
            self._commit_durable()
        return self.epoch

    # ------------------------------------------------------------------
    @staticmethod
    def _pad_pow2(n: int, floor: int = 8) -> int:
        """Bucket batch sizes to powers of two (the reference's query
        padding, kept: padded queries are (0, 0) digests)."""
        p = floor
        while p < n:
            p <<= 1
        return p

    def _lookup_rows(self, st: _EpochView, digest_pairs: np.ndarray,
                     table=None) -> np.ndarray:
        """One batched device lookup: (Q, 2) uint64 pairs → (Q,) row ids.
        Main-table lookups (table=None) probe the epoch's pinned
        sub-table first, then map sorted-view positions back to stable
        row ids through ``view_rows``."""
        from ..kernels.ops import key64, path_lookup
        q = digest_pairs.shape[0]
        if q == 0:
            return np.zeros((0,), dtype=np.int32)
        if table is None:
            keys, pinned = st.keys, st.pinned
        else:
            keys, pinned = table, None
        qp = self._pad_pow2(q)
        if qp != q:
            # (0, 0) can never collide with an FNV digest of a non-empty
            # path; the padded tail is sliced off regardless
            pad = np.zeros((qp - q, 2), dtype=np.uint64)
            digest_pairs = np.concatenate([digest_pairs, pad])
        rows = path_lookup(
            keys, self._to_device(key64(digest_pairs[:, 0], digest_pairs[:, 1])),
            pinned=pinned)
        rows = rows.cpu().numpy()[:q]
        if table is None:
            # sorted-view position → row id, clipped against the padded
            # key-table tail
            n_view = len(st.view_rows)
            valid = (rows >= 0) & (rows < n_view)
            safe = np.clip(rows, 0, max(n_view - 1, 0))
            return np.where(valid, st.view_rows[safe], -1).astype(np.int32)
        n_rows = len(st.tok_offsets) - 1
        return np.where(rows >= n_rows, -1, rows)

    def _digests(self, paths: list[str]) -> np.ndarray:
        out = np.zeros((len(paths), 2), dtype=np.uint64)
        for i, p in enumerate(paths):
            h = P.path_hash(p)
            out[i] = ((h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF)
        return out

    def _norm(self, paths: Sequence[str]) -> list[str]:
        return [P.normalize(p, depth_budget=self.depth_budget) for p in paths]

    # ------------------------------------------------------------------
    def q1_get(self, paths):
        self.stats.record(Q1, len(paths))
        with obs.span("device.q1_get"):
            st = self._st
            norm = self._norm(paths)
            rows = self._lookup_rows(st, self._digests(norm))
            return [st.records[r] if r >= 0 else None for r in rows]

    def q2_ls(self, paths):
        """One batched lookup; children come co-located in the resolved
        directory record ("children co-located with the parent"), so no
        second device op is needed.  (TensorWiki's CSR serves row-level
        traversal in core/tensorstore.py; the engine's record table
        already carries the same lists.)"""
        self.stats.record(Q2, len(paths))
        with obs.span("device.q2_ls"):
            st = self._st
            norm = self._norm(paths)
            rows = self._lookup_rows(st, self._digests(norm))
            out = []
            for p, r in zip(norm, rows):
                rec = st.records[r] if r >= 0 else None
                if rec is None or not isinstance(rec, R.DirRecord):
                    out.append(None)
                    continue
                out.append((rec, [P.child(p, s) for s in rec.children()]))
            return out

    def q3_navigate(self, paths):
        """The whole batch's ancestor chains flatten into ONE lookup
        launch — step compression applied to the storage layer itself."""
        self.stats.record(Q3, len(paths))
        with obs.span("device.q3_navigate"):
            st = self._st
            norm = self._norm(paths)
            chains = [list(P.ancestors(p)) + [p] for p in norm]
            flat = [a for chain in chains for a in chain]
            rows = self._lookup_rows(st, self._digests(flat))
            # the flat lookup resolves every level even past a miss (the
            # batch is issued before results are known); the per-path
            # result still truncates at the first miss, matching
            # PathStore.navigate
            return self._q3_truncate(st, chains, rows)

    @staticmethod
    def _q3_truncate(st: _EpochView, chains, rows) -> list[list[R.Record]]:
        out: list[list[R.Record]] = []
        i = 0
        for chain in chains:
            recs: list[R.Record] = []
            stopped = False
            for _ in chain:
                r = rows[i]
                i += 1
                if stopped:
                    continue
                rec = st.records[r] if r >= 0 else None
                if rec is None:
                    stopped = True
                else:
                    recs.append(rec)
            out.append(recs)
        return out

    def q4_search(self, prefixes, limit=None):
        """One prefix_search launch for the whole prefix batch: every
        pending prefix is compared against each resident path tile.  The
        scan runs over the row-order token matrix (free slots are zeros,
        tombstones 255s — neither can match a real prefix), so a patch
        refresh only re-uploads the touched rows."""
        self.stats.record(Q4, len(prefixes))
        if not prefixes:
            return []
        with obs.span("device.q4_search"):
            return self._q4_search(prefixes, limit)

    def _q4_search(self, prefixes, limit):
        from . import tensorstore as TS
        from ..kernels.ops import prefix_search
        st = self._st
        fixed = [p if p.startswith(P.SEP) else P.SEP + p for p in prefixes]
        L = self._max_path_bytes
        qp = self._pad_pow2(len(fixed), floor=4)
        # pad with unmatchable prefixes (0xFF never occurs in a path), as
        # the reference does for its bucketed shapes
        pref_mat = np.full((qp, L), 255, dtype=np.uint8)
        lens = np.full((qp,), 1, dtype=np.int32)
        long_idx: set[int] = set()
        for i, p in enumerate(fixed):
            blen = len(p.encode("utf-8"))
            if blen >= L:
                # the packed token matrix truncates at L bytes, so the
                # kernel cannot decide these exactly — resolve them from
                # the untruncated host-side path list instead (rare: the
                # depth budget keeps normal prefixes far below L)
                long_idx.add(i)
            else:
                pref_mat[i] = TS.pack_path(p, L)
                lens[i] = blen
        n_paths = len(st.paths)
        bitmap = prefix_search(st.ptoks, self._to_device(pref_mat),
                               self._to_device(lens))
        # the hits leave the device as (prefix, row) pairs in prefix-major
        # order, not as the whole (N, Q) bitmap
        qi_hit, row_hit = bitmap[:n_paths, :len(fixed)].t().nonzero(as_tuple=True)
        qi_hit = qi_hit.cpu().numpy()
        row_hit = row_hit.cpu().numpy()
        bounds = np.searchsorted(qi_hit, np.arange(len(fixed) + 1))
        out: list[list[str]] = []
        for qi in range(len(fixed)):
            if qi in long_idx:
                seg_pref = fixed[qi].rstrip(P.SEP) or P.ROOT
                matches = sorted(
                    p for p in st.wiki.row_of
                    if p.startswith(fixed[qi])
                    and (P.is_prefix(seg_pref, p) or p == fixed[qi]))
                out.append(matches if limit is None else matches[:limit])
                continue
            hits = row_hit[bounds[qi]:bounds[qi + 1]]
            matches = sorted(st.paths[r] for r in hits)
            out.append(matches if limit is None else matches[:limit])
        return out

    def q4_contains(self, tokens, limit=None):
        """Keyword routing: the segment-token inverted index as a device
        lookup — token digests through the SAME path_lookup kernel,
        then a CSR slice of matching path rows (or the epoch's
        copy-on-write overlay for tokens a patch refresh touched).  Exact
        segment-token semantics, identical to PathStore.search_contains."""
        self.stats.record(Q4C, len(tokens))
        if not tokens:
            return []
        with obs.span("device.q4_contains"):
            st = self._st
            norm_toks = [t.lower() for t in tokens]
            dig = np.zeros((len(norm_toks), 2), dtype=np.uint64)
            for i, t in enumerate(norm_toks):
                h = _token_hash(t)
                dig[i] = ((h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF)
            rows = self._lookup_rows(st, dig, table=st.tok_keys)
            out: list[list[str]] = []
            for t, r in zip(norm_toks, rows):
                if r >= 0:
                    over = st.tok_patch.get(int(r))
                    if over is not None:
                        prows = over
                    else:
                        lo, hi = st.tok_offsets[r], st.tok_offsets[r + 1]
                        prows = st.tok_rows[lo:hi]
                else:
                    # token absent from the packed table — it may have
                    # been introduced by a patch refresh since the last
                    # rebuild
                    prows = st.tok_extra.get(t, ())
                matches = [st.paths[i] for i in prows]
                out.append(matches if limit is None else matches[:limit])
            return out


# ---------------------------------------------------------------------------
# batch planner
# ---------------------------------------------------------------------------
class OpFuture:
    """Handle for one pending engine operation.  ``value`` is valid after
    the planner flush that executed its batch."""

    __slots__ = ("op", "arg", "value", "done")

    def __init__(self, op: str, arg):
        self.op = op
        self.arg = arg
        self.value = None
        self.done = False

    def result(self):
        if not self.done:
            raise RuntimeError(
                f"operation {self.op}({self.arg!r}) not flushed yet")
        return self.value


class BatchPlanner:
    """Collects Q1–Q4 operations — and now writes — from many concurrent
    sessions and executes each operator's pending set in ONE engine call
    per flush.

    Identical read operations from different sessions are deduplicated
    into a single batch slot (they share the result), so a flush costs at
    most five read round trips — one per live operator — regardless of
    how many sessions are in flight.  Writes are collected in enqueue
    order and are never deduplicated (two admissions of the same path are
    two intents, applied in order): the flush batches them as maximal
    same-kind runs, preserving cross-kind order, so unlink-then-readmit
    keeps its meaning.

    **Wave semantics** (the epoch contract of ``QueryEngine``): a flush
    executes all read batches FIRST, then the write batches.  Reads of a
    flush therefore never observe that flush's writes; visibility arrives
    at the driver's ``engine.refresh()`` between waves (Δ = 1 wave).
    """

    def __init__(self, engine: QueryEngine):
        self.engine = engine
        self._pending: dict[str, dict[object, list[OpFuture]]] = {}
        self._writes: list[tuple[str, object, OpFuture]] = []
        self._lock = threading.Lock()
        self.flushes = 0

    # -- operation futures --------------------------------------------------
    def _enqueue(self, op: str, key, arg) -> OpFuture:
        fut = OpFuture(op, arg)
        with self._lock:
            self._pending.setdefault(op, {}).setdefault(key, []).append(fut)
        return fut

    def get(self, path: str) -> OpFuture:
        return self._enqueue(Q1, path, path)

    def ls(self, path: str) -> OpFuture:
        return self._enqueue(Q2, path, path)

    def navigate(self, path: str) -> OpFuture:
        return self._enqueue(Q3, path, path)

    def search(self, prefix: str, limit: int | None = None) -> OpFuture:
        return self._enqueue(Q4, (prefix, limit), prefix)

    def contains(self, token: str, limit: int | None = None) -> OpFuture:
        return self._enqueue(Q4C, (token, limit), token)

    # -- write futures ------------------------------------------------------
    def _enqueue_write(self, op: str, payload) -> OpFuture:
        fut = OpFuture(op, payload)
        with self._lock:
            self._writes.append((op, payload, fut))
        return fut

    def admit(self, path: str, rec: R.Record) -> OpFuture:
        """Batched §IV-C admission; resolves to the admitted record."""
        return self._enqueue_write(W_ADMIT, (path, rec))

    def update(self, path: str,
               mutate: Callable[[R.FileRecord], R.FileRecord]) -> OpFuture:
        """Batched OCC update; resolves to the new record, or to the
        ``CASConflict`` instance if retries were exhausted."""
        return self._enqueue_write(W_UPDATE, (path, mutate))

    def unlink(self, path: str) -> OpFuture:
        """Batched reverse-order unlink; resolves to existed: bool."""
        return self._enqueue_write(W_UNLINK, path)

    def pending_ops(self) -> int:
        return (sum(len(futs) for by_key in self._pending.values()
                    for futs in by_key.values())
                + len(self._writes))

    def pending_writes(self) -> int:
        return len(self._writes)

    # -- execution ----------------------------------------------------------
    def flush(self) -> int:
        """Execute every pending batch; one engine call per operator kind,
        reads before writes.  Returns the number of futures resolved."""
        with self._lock:
            pending, self._pending = self._pending, {}
            writes, self._writes = self._writes, []
        if not pending and not writes:
            return 0
        depth = (sum(len(futs) for by_key in pending.values()
                     for futs in by_key.values()) + len(writes))
        self.flushes += 1
        obs.set_context(wave=self.flushes)
        obs.gauge("planner.queue_depth").set(depth)
        resolved = 0
        with obs.span("planner.flush", depth=depth,
                      writes=len(writes)) as sp:
            # reads first — every read of this wave sees the epoch pinned
            # at wave start, untouched by this wave's writes
            for op in READ_OPS:
                by_key = pending.get(op)
                if not by_key:
                    continue
                keys = list(by_key)
                if op == Q1:
                    results = self.engine.q1_get(keys)
                elif op == Q2:
                    results = self.engine.q2_ls(keys)
                elif op == Q3:
                    results = self.engine.q3_navigate(keys)
                elif op == Q4:
                    # group by limit so one call covers each limit class
                    results = self._ranged(self.engine.q4_search, keys)
                else:
                    results = self._ranged(self.engine.q4_contains, keys)
                n_served = 0
                for key, value in zip(keys, results):
                    for fut in by_key[key]:
                        fut.value = value
                        fut.done = True
                        n_served += 1
                self.engine.stats.record_served(op, n_served)
                resolved += n_served
            resolved += self._flush_writes(writes)
            sp.set(resolved=resolved)
        return resolved

    def _flush_writes(self, writes) -> int:
        """Execute the ordered write log as maximal same-kind runs: one
        engine call per run, cross-kind enqueue order preserved.  A
        homogeneous wave (the common case) still costs one round trip;
        an unlink-then-readmit of the same path keeps its meaning."""
        methods = {W_ADMIT: self.engine.admit_many,
                   W_UPDATE: self.engine.update_many,
                   W_UNLINK: self.engine.unlink_many}
        resolved = 0
        i = 0
        while i < len(writes):
            op = writes[i][0]
            j = i
            while j < len(writes) and writes[j][0] == op:
                j += 1
            batch = writes[i:j]
            try:
                results = methods[op]([payload for _, payload, _ in batch])
            except Exception as e:
                # the engines resolve expected per-item failures to
                # exception values; anything that still escapes must not
                # leave this wave's futures dangling forever — resolve
                # them to the failure and keep the wave going
                results = [e] * len(batch)
            for (_, _, fut), value in zip(batch, results):
                fut.value = value
                fut.done = True
            self.engine.stats.record_served(op, len(batch))
            resolved += len(batch)
            i = j
        return resolved

    @staticmethod
    def _grouped_by_limit(keys):
        groups: dict[int | None, list] = {}
        for k in keys:
            groups.setdefault(k[1], []).append(k)
        return groups

    def _ranged(self, method, keys):
        """Execute (arg, limit) keyed scans: one engine call per distinct
        limit (usually exactly one)."""
        by_limit = self._grouped_by_limit(keys)
        res: dict[object, list[str]] = {}
        for limit, ks in by_limit.items():
            outs = method([k[0] for k in ks], limit=limit)
            for k, o in zip(ks, outs):
                res[k] = o
        return [res[k] for k in keys]


def drive(gen, planner: BatchPlanner):
    """Run one session generator to completion, flushing the planner at
    every yield point (the single-session degenerate case of the
    multi-session scheduler in navigate.run_sessions).  The session is
    one wave: any writes it admitted become visible at the closing
    ``refresh()``."""
    try:
        while True:
            next(gen)
            planner.flush()
    except StopIteration as e:
        planner.engine.refresh()
        return e.value


def admit_wave(planner: BatchPlanner,
               items: Sequence[tuple[str, R.Record]]) -> list[OpFuture]:
    """Writer-session helper: enqueue a batch of admissions that will ride
    the next wave's flush exactly like reader sessions' ops do."""
    return [planner.admit(p, rec) for p, rec in items]


def unlink_wave(planner: BatchPlanner, paths: Sequence[str]) -> list[OpFuture]:
    """Writer-session helper for batched unlinks."""
    return [planner.unlink(p) for p in paths]


__all__ = ["QueryEngine", "HostEngine", "DeviceEngine", "ShardedPathStore",
           "BatchPlanner", "OpFuture", "EngineStats", "drive",
           "admit_wave", "unlink_wave",
           "Q1", "Q2", "Q3", "Q4", "Q4C",
           "W_ADMIT", "W_UPDATE", "W_UNLINK", "REFRESH"]

"""Shard fan-out executor + pipelined commit sequencer (ISSUE 10).

Two small concurrency primitives that take the serial loops off the
sharded hot path while keeping ``REPRO_SHARD_WORKERS=0`` (the default)
bit-identical to the pre-executor for-loops:

* :class:`ShardExecutor` — the scatter/gather seam between
  ``ShardedPathStore`` and its shards.  ``scatter(fn, items)`` calls
  ``fn(index, item)`` for every item and gathers the results *in item
  order*; with ``workers == 0`` that is a plain list comprehension on
  the caller thread, with ``workers > 0`` the calls run on a shared
  thread pool so a slow shard no longer serializes behind its peers.
  The API is deliberately RPC-shaped — per-shard callables carry no
  shared mutable state and results come back positionally — so the
  future multi-process shard tier (ROADMAP) can replace the pool submit
  with a socket round trip without touching any call site.

* :class:`CommitSequencer` — depth-1 pipelined group commit.  A wave's
  WAL bytes are *sealed* synchronously under the shard locks (cheap
  buffer swap), then written + fsynced off-thread while the caller
  returns to compute the next wave; ``wait()`` joins the in-flight wave
  before the next seal, re-raising any worker failure on the caller
  thread.  Invariant: at most ONE sealed-but-not-yet-durable wave
  exists, and the *advertised* durable epoch (:meth:`durable_epoch`)
  advances only when that wave's fsync has landed — so the Δ = 1
  visibility contract never claims durability it does not have.

Observability: ``executor.queue_depth`` / ``executor.utilization``
gauges track scatter load; ``commit.pipeline_depth`` is 1 while a
sealed wave is in flight and 0 once it is durable.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Sequence, TypeVar

from .. import obs

#: ``REPRO_SHARD_WORKERS`` — thread-pool size for shard fan-outs
#: (default 0 = serial on the caller thread, bit-compatible)
WORKERS_ENV = "REPRO_SHARD_WORKERS"
#: ``REPRO_COMMIT_PIPELINE`` — overlap wave e's WAL fsync with wave
#: e+1's compute (default 0 = synchronous group commit)
PIPELINE_ENV = "REPRO_COMMIT_PIPELINE"

_TRUTHY = ("1", "true", "on", "yes")

T = TypeVar("T")
R = TypeVar("R")


def resolve_shard_workers(explicit: int | None = None) -> int:
    """Resolve the fan-out pool size (arg > env > default 0 = serial)."""
    val = explicit if explicit is not None else \
        int(os.environ.get(WORKERS_ENV, "0"))
    if val < 0:
        raise ValueError(f"shard workers must be >= 0, got {val}")
    return val


def resolve_commit_pipeline(explicit: bool | None = None) -> bool:
    """Resolve the pipelined-commit switch (arg > env > default off)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(PIPELINE_ENV, "0").strip().lower() in _TRUTHY


class ShardExecutor:
    """Scatter/gather fan-out over shard-indexed work items.

    ``workers == 0`` (or a 0/1-item scatter) runs inline on the caller
    thread — same call order, same exception propagation, bit-identical
    results to the serial loops it replaced.  ``workers > 0`` submits
    every item to one lazily created shared pool and gathers in item
    order; the first item failure is re-raised on the caller thread,
    but only after every sibling has finished, so a failed fan-out
    never leaves stray work mutating the shards behind the caller.
    """

    def __init__(self, workers: int | None = None):
        self.workers = resolve_shard_workers(workers)
        self._pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()
        self._inflight = 0

    def _ensure_pool(self) -> ThreadPoolExecutor:
        pool = self._pool
        if pool is None:
            with self._lock:
                pool = self._pool
                if pool is None:
                    pool = self._pool = ThreadPoolExecutor(
                        max_workers=self.workers,
                        thread_name_prefix="shard-exec")
        return pool

    def scatter(self, fn: Callable[[int, T], R], items: Iterable[T]
                ) -> list[R]:
        """``[fn(0, items[0]), fn(1, items[1]), ...]`` — concurrently
        when the pool is on, always gathered in item order."""
        work: Sequence[T] = items if isinstance(items, (list, tuple)) \
            else list(items)
        if self.workers == 0 or len(work) <= 1:
            return [fn(i, item) for i, item in enumerate(work)]
        pool = self._ensure_pool()
        with self._lock:
            self._inflight += len(work)
            depth = self._inflight
        obs.gauge("executor.queue_depth").set(depth)
        obs.gauge("executor.utilization").set(
            round(min(1.0, depth / self.workers), 4))
        try:
            futs = [pool.submit(fn, i, item) for i, item in enumerate(work)]
            out: list[R] = []
            first: BaseException | None = None
            for f in futs:
                try:
                    out.append(f.result())
                except BaseException as e:          # noqa: BLE001 - re-raised
                    if first is None:
                        first = e
                    out.append(None)                # type: ignore[arg-type]
            if first is not None:
                raise first
            return out
        finally:
            with self._lock:
                self._inflight -= len(work)
                depth = self._inflight
            obs.gauge("executor.queue_depth").set(depth)

    def close(self) -> None:
        """Shut the pool down (idempotent; a later scatter re-creates it)."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


class CommitSequencer:
    """Depth-1 commit pipeline: fsync of wave e overlaps compute of e+1.

    ``submit(epoch, completes)`` hands the sealed wave's deferred
    durability closures (WAL write + fsync + frozen-memtable spill per
    shard) to a dedicated single worker thread, which fans them out
    through the owning store's :class:`ShardExecutor`; ``wait()`` joins
    the in-flight wave and only then advances the advertised durable
    epoch.  A worker failure (IO error, injected crash) is re-raised by
    the next ``wait()`` on the caller thread — the epoch it carried is
    never advertised as durable.
    """

    def __init__(self, executor: ShardExecutor, durable_epoch: int = 0):
        self._exec = executor
        self._worker = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="commit-seq")
        self._pending: tuple[int, Future] | None = None
        self._durable = durable_epoch

    def durable_epoch(self) -> int:
        """Newest epoch whose fsync has LANDED (never the sealed one)."""
        return self._durable

    def depth(self) -> int:
        """Sealed-but-not-yet-durable waves in flight (0 or 1)."""
        return 0 if self._pending is None else 1

    def wait(self) -> None:
        """Join the in-flight wave; re-raises its failure here.  The
        durable epoch advances exactly when this returns cleanly."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        epoch, fut = pending
        obs.gauge("commit.pipeline_depth").set(0)
        fut.result()
        self._durable = max(self._durable, epoch)

    def submit(self, epoch: int,
               completes: Sequence[Callable[[], None]]) -> None:
        """Launch the sealed wave's durability work off-thread.  An
        empty wave (every shard skipped the commit) is durable by
        definition — the epoch advances immediately."""
        assert self._pending is None, \
            "commit pipeline is depth-1: wait() before the next submit"
        if not completes:
            self._durable = max(self._durable, epoch)
            return
        fut = self._worker.submit(
            self._exec.scatter, lambda i, c: c(), list(completes))
        self._pending = (epoch, fut)
        obs.gauge("commit.pipeline_depth").set(1)

    # drain is wait by another name — call sites read better with it
    drain = wait

    def close(self) -> None:
        """Drain the in-flight wave (propagating its failure) and stop
        the worker thread."""
        try:
            self.wait()
        finally:
            self._worker.shutdown(wait=True)

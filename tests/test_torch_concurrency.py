"""The reference's concurrency suite over the port: parallel shard
fan-out, pipelined group commit, background compaction, and the
DeviceEngine (``device="cpu"``) under concurrent readers.

Four invariant families:

1. **Scatter parity** — ``REPRO_SHARD_WORKERS=4`` returns bit-identical
   results to the serial loops for every fan-out shape (point batches,
   namespace scans, k-way merges), and executor failures propagate to
   the caller only after every sibling task has finished.
2. **Thread-safe telemetry** — hammering one durable
   engine from many threads never drops an op-counter increment, and
   the block-cache hit+miss total stays exact under contention.
3. **Pipelined commit** — the advertised durable epoch only ever trails
   the sealed epoch by the one in-flight wave, worker failures re-raise
   on the caller thread before the epoch is advertised, and a drained
   pipelined store reopens byte-identical to a synchronous one.
4. **Δ = 1 under full concurrency** — the epoch-pinning /
   one-wave-staleness property holds with the fan-out pool, the commit
   pipeline, and background compaction all enabled at once.
"""
import threading
import time

import pytest

from repro_torch.core import paths as P
from repro_torch.core import records as R
from repro_torch.core.consistency import WikiWriter
from repro_torch.core.engine import (BatchPlanner, DeviceEngine, HostEngine,
                                     ShardedPathStore)
from repro_torch.core.executor import CommitSequencer, ShardExecutor
from repro_torch.core.store import MemKV, PathStore
from repro_torch.storage import DurableKV, open_durable_store
from repro_torch.storage import failpoints as FPS

from test_torch_durable_engine import _query_batches, _random_wiki

#: the torch device of every DeviceEngine here (the card tests rerun the
#: DeviceEngine cases with "cuda")
DEVICE = "cpu"


# ---------------------------------------------------------------------------
# 1. scatter parity + executor semantics
# ---------------------------------------------------------------------------
def _pair(seed: int) -> tuple[ShardedPathStore, ShardedPathStore]:
    serial = ShardedPathStore(n_shards=8, memtable_limit=32,
                              shard_workers=0)
    fanned = ShardedPathStore(n_shards=8, memtable_limit=32,
                              shard_workers=4)
    mat = _random_wiki(serial, seed)
    _random_wiki(fanned, seed)
    return serial, fanned, mat


@pytest.mark.parametrize("seed", [3, 17, 59])
def test_parallel_fanout_parity(seed):
    """Workers change WHERE per-shard work runs, never what it returns."""
    serial, fanned, mat = _pair(seed)
    q1, q2, q3, prefixes, tokens = _query_batches(mat)
    assert fanned.get_many(q1) == [serial.get(p) for p in q1]
    assert fanned.ls_many(q2) == [serial.ls(p) for p in q2]
    assert fanned.navigate_many(q3) == [serial.navigate(p) for p in q3]
    for pre in prefixes:
        assert fanned.search(pre) == serial.search(pre)
        assert fanned.search(pre, limit=3) == serial.search(pre, limit=3)
    for tok in tokens:
        assert fanned.search_contains(tok) == serial.search_contains(tok)
    assert fanned.all_paths() == serial.all_paths()
    assert fanned.count() == serial.count()
    # the batched APIs are what HostEngine routes through
    hs, hf = HostEngine(serial), HostEngine(fanned)
    assert hs.q1_get(q1) == hf.q1_get(q1)
    assert hs.q2_ls(q2) == hf.q2_ls(q2)
    assert hs.q3_navigate(q3) == hf.q3_navigate(q3)


def test_merge_is_ordered_and_limit_correct():
    """The k-way merge keeps global path order and the global first
    ``limit`` paths (each shard over-fetches its own first ``limit``)."""
    store = ShardedPathStore(n_shards=4, memtable_limit=64, shard_workers=2)
    w = WikiWriter(store, clock=lambda: 0.0)
    w.ensure_root("root")
    w.admit("/d", R.DirRecord(name="d"))
    paths = [f"/d/n{i:03d}" for i in range(40)]
    for p in paths:
        w.admit(p, R.FileRecord(name=P.basename(p), text=p))
    got = store.search("/d/")
    assert got == sorted(got) and set(paths) <= set(got)
    for lim in (1, 7, 100):
        assert store.search("/d/", limit=lim) == got[:lim]
    assert store.all_paths() == sorted(store.all_paths())


def test_executor_failure_waits_for_siblings():
    """The first scatter failure re-raises on the caller — but only
    after every sibling finished (no stray work left mutating shards)."""
    ex = ShardExecutor(workers=4)
    done = []

    def fn(i, item):
        if i == 1:
            raise RuntimeError("shard 1 down")
        time.sleep(0.02)
        done.append(i)
        return i

    with pytest.raises(RuntimeError, match="shard 1 down"):
        ex.scatter(fn, list(range(6)))
    assert sorted(done) == [0, 2, 3, 4, 5]
    ex.close()


def test_executor_serial_mode_is_inline():
    """workers=0 runs on the caller thread in item order (the RPC-shaped
    seam degrades to exactly the pre-executor for-loop)."""
    ex = ShardExecutor(workers=0)
    seen = []
    out = ex.scatter(lambda i, s: seen.append((i, threading.get_ident()))
                     or i * 10, ["a", "b", "c"])
    assert out == [0, 10, 20]
    assert [i for i, _ in seen] == [0, 1, 2]
    assert {t for _, t in seen} == {threading.get_ident()}


# ---------------------------------------------------------------------------
# 2. durable-stat thread safety
# ---------------------------------------------------------------------------
def test_op_counters_exact_under_hammer(tmp_path):
    """8 threads × 300 ops: every ``_count`` increment lands (the
    read-modify-write is locked), and the block-cache hit+miss TOTAL
    equals the lookup count even though the hit/miss split is
    schedule-dependent."""
    from repro_torch.storage.sstable import BlockCache
    kv = DurableKV(str(tmp_path / "kv"), memtable_limit=8, sync="none",
                   segment_target_bytes=64,
                   block_cache=BlockCache(capacity_bytes=256))
    keys = [f"h{i:03d}".encode() for i in range(64)]
    for i, k in enumerate(keys):
        kv.put(k, b"v" * 16)
        if i % 8 == 7:
            kv.commit_epoch(i)          # spill → reads go through segments
    kv.spill()
    base = kv.op_counts()
    n_threads, n_ops = 8, 300
    errs = []

    def hammer(t):
        try:
            for j in range(n_ops):
                assert kv.get(keys[(t * 7 + j) % len(keys)]) is not None
        except BaseException as e:      # noqa: BLE001 - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    counts = kv.op_counts()
    total = n_threads * n_ops
    assert counts["get"] - base.get("get", 0) == total
    # every probed block does exactly one cache lookup: hit+miss is exact
    lookups = (counts.get("cache_hit", 0) + counts.get("cache_miss", 0)
               - base.get("cache_hit", 0) - base.get("cache_miss", 0))
    probes = counts.get("seg_probe", 0) - base.get("seg_probe", 0)
    assert lookups >= total              # ≥1 block read per segment get
    assert probes >= total
    kv.close()


# ---------------------------------------------------------------------------
# 3. pipelined group commit
# ---------------------------------------------------------------------------
def _durable_sharded(root, **kw):
    kw.setdefault("n_shards", 2)
    kw.setdefault("sync", "none")
    return open_durable_store(str(root), **kw)


def test_pipeline_advertises_only_landed_epochs(tmp_path):
    store = _durable_sharded(tmp_path / "w", shard_workers=2,
                             commit_pipeline=True)
    w = WikiWriter(store, clock=lambda: 0.0)
    w.ensure_root("root")
    assert store.durable_epoch() == store.last_epoch()
    w.admit("/a", R.DirRecord(name="a"))
    store.commit_epoch(1)
    # wave 1 is sealed (visible, owns the epoch) but its WAL write may
    # still be in flight: the advertised durable epoch must not lead it
    assert store.last_epoch() == 1
    assert store.durable_epoch() <= 1
    assert store.commit_pipeline_depth() in (0, 1)
    w.admit("/a/b", R.FileRecord(name="b", text="b"))
    store.commit_epoch(2)               # joins wave 1 first (depth 1)
    assert store.durable_epoch() >= 1
    store.flush()                        # drain: everything durable
    assert store.durable_epoch() == store.last_epoch() == 2
    assert store.commit_pipeline_depth() == 0
    store.close()


def test_pipelined_store_reopens_identical(tmp_path):
    """Pipelined waves + close() drain a store that reopens exactly as a
    synchronous-commit twin of the same schedule."""
    roots = (tmp_path / "pipe", tmp_path / "sync")
    stores = (_durable_sharded(roots[0], shard_workers=2,
                               commit_pipeline=True),
              _durable_sharded(roots[1], commit_pipeline=False))
    for s in stores:
        _random_wiki(s, 23)
        for e in range(1, 4):
            s.put_record(f"/wave{e}", R.FileRecord(name=f"wave{e}",
                                                   text=str(e)))
            s.commit_epoch(e)
        s.close()
    a = open_durable_store(str(roots[0]), sync="none")
    b = open_durable_store(str(roots[1]), sync="none")
    assert a.all_paths() == b.all_paths()
    assert a.last_epoch() == b.last_epoch()
    for p in a.all_paths():
        assert a.get(p) == b.get(p)
    a.close()
    b.close()


def test_pipeline_worker_failure_reraises_before_advertising(tmp_path):
    """An injected crash in the off-thread WAL write parks in the
    sequencer; the NEXT commit re-raises it on the caller thread and the
    wounded epoch is never advertised durable."""
    store = _durable_sharded(tmp_path / "w", shard_workers=2,
                             commit_pipeline=True)
    w = WikiWriter(store, clock=lambda: 0.0)
    w.ensure_root("root")
    store.flush()                        # root wave durable, pipeline empty
    before = store.durable_epoch()
    w.admit("/x", R.DirRecord(name="x"))
    with FPS.armed(FPS.FailPlan(crash_at=1,
                                sites=frozenset({"wal.commit"}))):
        store.commit_epoch(before + 1)   # seal ok; off-thread write dies
        with pytest.raises(FPS.InjectedCrash):
            store.commit_epoch(before + 2)
    assert store.durable_epoch() == before
    store._sequencer = None              # wounded wave abandoned (crash)
    store.close()


def test_sequencer_empty_wave_advances_immediately():
    ex = ShardExecutor(workers=2)
    seq = CommitSequencer(ex, durable_epoch=5)
    seq.submit(6, [])
    assert seq.durable_epoch() == 6 and seq.depth() == 0
    fired = []
    seq.submit(7, [lambda: fired.append(1)])
    assert seq.depth() == 1
    seq.wait()
    assert fired == [1] and seq.durable_epoch() == 7
    seq.close()
    ex.close()


# ---------------------------------------------------------------------------
# 4. background compaction + the full-concurrency Δ = 1 property
# ---------------------------------------------------------------------------
def _drain_bg(kv, deadline=10.0):
    t0 = time.monotonic()
    while kv.compact_debt() > 0:
        if time.monotonic() - t0 > deadline:
            pytest.fail("background compaction never drained")
        time.sleep(0.005)


def test_bg_compaction_drains_off_thread(tmp_path):
    """Commits enqueue merge debt for the daemon worker instead of
    paying it inline; the worker drains it and reads stay exact."""
    kv = DurableKV(str(tmp_path / "kv"), memtable_limit=4, sync="none",
                   level_ratio=2, segment_target_bytes=48,
                   compact_budget_bytes=150, bg_compact=True)
    assert kv._bg_thread is not None and kv._bg_thread.is_alive()
    expect = {}
    for i in range(48):
        k = f"k{i % 12:02d}".encode()
        v = f"v{i:03d}".encode()
        kv.put(k, v)
        expect[k] = v
        if i % 4 == 3:
            kv.commit_epoch(i)
    _drain_bg(kv)
    assert dict(kv.scan(b"")) == expect
    kv.close()


def test_bg_worker_failure_is_sticky(tmp_path):
    """A parked background failure re-raises on the next mutation AND on
    close() — a wounded store is never cleanly committed."""
    kv = DurableKV(str(tmp_path / "kv"), memtable_limit=4, sync="none",
                   bg_compact=True)
    kv.put(b"a", b"1")
    kv.commit_epoch(1)
    kv._stop_bg()                        # park deterministically
    kv._bg_exc = RuntimeError("merge died")
    with pytest.raises(RuntimeError, match="merge died"):
        kv.put(b"b", b"2")
    with pytest.raises(RuntimeError, match="merge died"):
        kv.close()
    kv._bg_exc = None                    # abandon like a dead process
    kv._wal._f.close()
    for t in kv._tables.values():
        t.close()
    reopened = DurableKV(str(tmp_path / "kv"), memtable_limit=4,
                         sync="none")
    assert dict(reopened.scan(b"")) == {b"a": b"1"}
    reopened.close()


def test_delta_one_wave_all_features_on(tmp_path):
    """The epoch-pinning / Δ = 1 staleness property with
    the fan-out pool, the commit pipeline, and background compaction all
    enabled.  Every read wave sees exactly the epoch it pinned; the
    advertised durable epoch never trails the pinned epoch by more than
    the one in-flight wave; the final state converges to a fresh
    freeze."""
    store = _durable_sharded(tmp_path / "w", n_shards=4, shard_workers=4,
                             commit_pipeline=True, bg_compact=True,
                             memtable_limit=8, segment_target_bytes=64)
    w = WikiWriter(store, clock=lambda: 0.0)
    w.ensure_root("root")
    for d in range(2):
        w.admit(f"/d{d}", R.DirRecord(name=f"d{d}", summary=f"dim {d}"))
        for e in range(3):
            w.admit(f"/d{d}/e{e}", R.FileRecord(name=f"e{e}", text=f"{d}:{e}"))
    dev = DeviceEngine.from_store(store, device=DEVICE)
    pl = BatchPlanner(dev)

    def snapshot():
        return {p: store.get(p) for p in store.all_paths()}

    pinned = snapshot()
    schedule = [("admit", d, e) for d in range(2) for e in range(3, 7)] + \
               [("unlink", d, e) for d in range(2) for e in range(3, 5)]
    for i, (kind, d, e) in enumerate(schedule):
        path = f"/d{d}/p{e}"
        probe = sorted(set(pinned) | {path})
        futs = [pl.get(p) for p in probe]
        if kind == "admit":
            pl.admit(path, R.FileRecord(name=f"p{e}", text=f"w{i}"))
        else:
            pl.unlink(path)
        pl.flush()
        for p, f in zip(probe, futs):
            assert f.value == pinned.get(p), \
                f"wave {i}: read of {p} escaped its pinned epoch"
        dev.refresh()
        assert store.last_epoch() - store.durable_epoch() <= 1
        pinned = snapshot()
    store.flush()
    assert store.durable_epoch() == store.last_epoch()
    fresh = DeviceEngine.from_store(store, device=DEVICE)
    paths = store.all_paths()
    assert dev.q1_get(paths) == fresh.q1_get(paths)
    store.close()


# ---------------------------------------------------------------------------
# 5. concurrent DeviceEngine readers against a committing writer
# ---------------------------------------------------------------------------
def device_readers_scenario(tmp_path, device, n_readers=3, n_waves=10, per_wave=4):
    """Reader threads issue Q1 and Q4 batches on a DeviceEngine while a
    writer thread admits whole waves through a BatchPlanner and commits
    each with ``refresh()`` (a durable group commit and a DEVMARK).  Every
    read batch must see whole waves only: a wave's files, and the
    directory record that lists them, together or not at all.  On a card
    every thread launches on a stream of its own.  Returns the Q1 and Q4
    batches the readers issued and the wave counts they saw."""
    import contextlib
    store = _durable_sharded(tmp_path / "w", n_shards=4, shard_workers=4,
                             commit_pipeline=True, memtable_limit=16)
    w = WikiWriter(store, clock=lambda: 0.0)
    w.ensure_root("root")
    w.admit("/d0", R.DirRecord(name="d0", summary="dim 0"))
    dev = DeviceEngine.from_store(store, device=device)
    flat = [f"/d0/w{i:02d}_{j}" for i in range(n_waves) for j in range(per_wave)]
    done = threading.Event()
    lock = threading.Lock()
    errors: list[BaseException] = []
    seen: set[int] = set()
    batches = {"q1": 0, "q4": 0}

    def own_stream():
        if dev.device.type != "cuda":
            return contextlib.nullcontext()
        import torch
        return torch.cuda.stream(torch.cuda.Stream(dev.device))

    def whole_waves(present: list[bool]) -> int:
        k = sum(present) // per_wave
        assert present == [True] * (k * per_wave) + [False] * (len(flat) - k * per_wave), \
            f"a read batch saw part of a wave: {present}"
        return k

    def read_once() -> int:
        got = dev.q1_get(["/d0"] + flat)
        k = whole_waves([r is not None for r in got[1:]])
        assert got[0].children() == [P.basename(p) for p in flat[:k * per_wave]], \
            "the directory record and its files come from different epochs"
        hits = set(dev.q4_search(["/d0"])[0])
        k4 = whole_waves([p in hits for p in flat])
        with lock:
            batches["q1"] += 1
            batches["q4"] += 1
            seen.update((k, k4))
        return k4

    def reader():
        try:
            with own_stream():
                while not done.is_set():
                    read_once()
                assert read_once() == n_waves
        except BaseException as e:  # noqa: BLE001 - surfaced on the main thread
            errors.append(e)

    def writer():
        try:
            with own_stream():
                pl = BatchPlanner(dev)
                for i in range(n_waves):
                    for p in flat[i * per_wave:(i + 1) * per_wave]:
                        pl.admit(p, R.FileRecord(name=P.basename(p), text=f"wave {i}"))
                    pl.flush()
                    assert dev.refresh() == i + 1
                    time.sleep(0.002)       # let the readers see this epoch
        except BaseException as e:  # noqa: BLE001 - surfaced on the main thread
            errors.append(e)
        finally:
            done.set()

    threads = [threading.Thread(target=reader) for _ in range(n_readers)]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a reader or the writer hung"
    if errors:
        raise errors[0]
    assert store.pending_invalidations() == []      # every wave DEVMARKed
    assert store.last_epoch() == dev.epoch == n_waves
    store.close()
    return batches, seen


def test_device_readers_never_see_a_partial_epoch(tmp_path):
    batches, seen = device_readers_scenario(tmp_path, DEVICE)
    # the readers started before the writer, and the last read of each
    # saw every wave
    assert batches["q1"] > 3 and 10 in seen and len(seen) >= 2

"""The reference's durable-storage suite over the port's copy of the
tier (``repro_torch.storage``): WAL framing + CRC, SSTable segments,
DurableKV crash recovery, and byte-identical store reopen."""
import os
import random
import shutil

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core import paths as P
from repro_torch.core import records as R
from repro_torch.core.oracle import HeuristicOracle
from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig
from repro_torch.core.store import MemKV, PathStore
from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace
from repro_torch.storage import (DurableKV, SSTable, open_durable_store,
                           write_sstable)
from repro_torch.storage import failpoints as FPS
from repro_torch.storage import manifest as MF
from repro_torch.storage import wal as W
from repro_torch.storage.lsm import WAL_NAME
from repro_torch.storage.sstable import MISSING, TOMBSTONE


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------
def test_wal_commit_boundaries_and_replay(tmp_path):
    p = str(tmp_path / "t.wal")
    w = W.WAL(p, sync="none")
    w.append_put(b"a", b"1")
    w.append_delete(b"b")
    w.append_inval("/d0/e0")
    w.commit(1)
    w.append_put(b"c", b"3")
    w.commit(2)
    w.append_put(b"never", b"committed")   # buffered, no commit
    w.close()
    res = W.replay(p)
    assert len(res.waves) == 2
    kinds = [rec.kind for rec in res.waves[0]]
    assert kinds == [W.PUT, W.DEL, W.INV, W.COMMIT]
    assert res.waves[0][2].path == "/d0/e0"
    assert res.waves[1][0].key == b"c"
    assert res.waves[1][-1].epoch == 2
    assert res.dropped_records == 0 and not res.corrupt_tail
    assert res.valid_end == os.path.getsize(p)   # buffer never hit disk


def test_wal_corrupt_tail_detected_and_dropped(tmp_path):
    p = str(tmp_path / "t.wal")
    w = W.WAL(p, sync="none")
    w.append_put(b"k", b"v")
    w.commit(1)
    w.close()
    good = os.path.getsize(p)
    # flip a byte inside an appended (committed-looking) record
    w2 = W.WAL(p, sync="none")
    w2.append_put(b"x", b"y")
    w2.commit(2)
    w2.close()
    with open(p, "rb+") as f:
        f.seek(good + 10)
        b = f.read(1)
        f.seek(good + 10)
        f.write(bytes([b[0] ^ 0xFF]))
    res = W.replay(p)
    assert res.corrupt_tail
    assert len(res.waves) == 1                    # only the intact wave
    assert res.valid_end == good


def test_wal_zero_filled_torn_tail(tmp_path):
    """A zero-filled tail (torn page after power loss) frames as
    crc=0/len=0, which crc32(b'') would pass — replay must still treat
    it as corrupt and the store must reopen cleanly."""
    p = str(tmp_path / "t.wal")
    w = W.WAL(p, sync="none")
    w.append_put(b"k", b"v")
    w.commit(1)
    w.close()
    good = os.path.getsize(p)
    with open(p, "ab") as f:
        f.write(b"\x00" * 64)
    res = W.replay(p)
    assert res.corrupt_tail and res.valid_end == good
    assert res.waves[-1][-1].epoch == 1
    d = str(tmp_path / "kv")
    kv = DurableKV(d, sync="none")
    kv.put(b"a", b"1")
    kv.commit_epoch(1)
    kv.close()
    with open(os.path.join(d, WAL_NAME), "ab") as f:
        f.write(b"\x00" * 64)
    kv2 = DurableKV(d, sync="none")               # must not raise
    assert kv2.recovery_corrupt_tail and kv2.get(b"a") == b"1"
    kv2.close()


def test_compact_after_reopen_preserves_committed_epoch(tmp_path):
    """Regression: the manifest written by a post-reopen spill/compact
    must carry the WAL-replayed epoch — the spill truncates the WAL that
    was the only record of it."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=10**9, sync="none")
    for e in range(1, 6):
        kv.put(f"k{e}".encode(), b"v")
        kv.commit_epoch(e)
    kv.close()
    kv2 = DurableKV(d, sync="none")
    assert kv2.last_epoch() == 5
    kv2.compact()                                 # spills + truncates WAL
    kv2.close()
    kv3 = DurableKV(d, sync="none")
    assert kv3.last_epoch() == 5, "compaction regressed the committed epoch"
    kv3.close()


def test_wal_torn_partial_frame(tmp_path):
    p = str(tmp_path / "t.wal")
    w = W.WAL(p, sync="none")
    w.append_put(b"k", b"v")
    w.commit(3)
    w.close()
    good = os.path.getsize(p)
    with open(p, "ab") as f:
        f.write(b"\x07\x00")                      # half a header
    res = W.replay(p)
    assert res.corrupt_tail and res.valid_end == good
    assert res.waves[-1][-1].epoch == 3


# ---------------------------------------------------------------------------
# SSTable
# ---------------------------------------------------------------------------
def test_sstable_get_scan_tombstones(tmp_path):
    items = sorted({f"k{i:03d}".encode(): f"v{i}".encode()
                    for i in range(100)}.items())
    items[7] = (items[7][0], TOMBSTONE)
    p = str(tmp_path / "a.seg")
    write_sstable(p, items, sync=False)
    t = SSTable(p)
    assert t.n_records == 100
    assert t.get(b"k005") == b"v5"
    assert t.get(items[7][0]) is TOMBSTONE        # delete persisted as such
    assert t.get(b"k0999") is MISSING
    assert t.get(b"a") is MISSING                 # before first key
    got = dict(t.scan(b"k01"))
    assert len(got) == 10 and got[b"k012"] == b"v12"
    assert len(list(t.iter_all())) == 100
    t.close()


def test_sstable_sparse_index_boundaries(tmp_path):
    # exactly SPARSE_EVERY-aligned + not-aligned sizes, single record
    for n in (1, 16, 17, 31):
        items = [(f"{i:04d}".encode(), b"x" * i) for i in range(n)]
        p = str(tmp_path / f"s{n}.seg")
        write_sstable(p, items, sync=False)
        t = SSTable(p)
        for k, v in items:
            assert t.get(k) == v
        assert t.get(b"zzzz") is MISSING
        t.close()


# ---------------------------------------------------------------------------
# DurableKV — crash recovery + MemKV parity
# ---------------------------------------------------------------------------
def test_tombstone_survives_spill_and_reopen(tmp_path):
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none")
    for i in range(6):
        kv.put(f"k{i}".encode(), b"old")
    kv.commit_epoch(1)                 # spills: all six live in segment 1
    kv.delete(b"k3")
    kv.put(b"k0", b"new")
    for i in range(6, 12):
        kv.put(f"k{i}".encode(), b"fresh")
    kv.commit_epoch(2)                 # spills again: tombstone in segment 2
    assert len(kv._manifest.segments) == 2
    kv.close()
    kv2 = DurableKV(d, sync="none")
    assert kv2.get(b"k3") is None, "delete resurrected across reopen"
    assert kv2.get(b"k0") == b"new"
    assert b"k3" not in dict(kv2.scan(b"k"))
    kv2.compact()                      # full merge may now drop the tombstone
    kv2.close()
    kv3 = DurableKV(d, sync="none")
    assert kv3.get(b"k3") is None
    assert kv3.get(b"k11") == b"fresh"
    kv3.close()


def test_crash_between_segment_write_and_manifest_swap(tmp_path):
    """The spill order is segment → manifest → WAL truncate; a crash
    after the segment write but before the manifest swap must lose
    nothing (WAL still holds the wave) and resurrect nothing (the orphan
    segment is swept)."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=10**9, sync="none")
    kv.put(b"a", b"1")
    kv.commit_epoch(1)
    kv.close()
    # simulate the crashed spill: an orphan segment containing records
    # that were NEVER committed, plus one committed key with a bogus value
    write_sstable(os.path.join(d, "seg_000042.seg"),
                  [(b"a", b"bogus"), (b"ghost", b"uncommitted")], sync=False)
    kv2 = DurableKV(d, sync="none")
    assert kv2.get(b"a") == b"1"                 # WAL replay wins
    assert kv2.get(b"ghost") is None             # orphan swept, not adopted
    assert not os.path.exists(os.path.join(d, "seg_000042.seg"))
    assert kv2.last_epoch() == 1
    kv2.close()


def test_uncommitted_wave_lost_committed_waves_exact(tmp_path):
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none")
    committed = {}
    for wave in range(5):
        for i in range(3):
            k = f"w{wave}k{i}".encode()
            kv.put(k, f"{wave}:{i}".encode())
            committed[k] = f"{wave}:{i}".encode()
        kv.commit_epoch(wave + 1)
    kv.put(b"uncommitted", b"x")                 # crash before commit
    del kv
    kv2 = DurableKV(d, sync="none")
    assert kv2.last_epoch() == 5
    assert kv2.get(b"uncommitted") is None
    assert dict(kv2.scan(b"")) == committed
    kv2.close()


@settings(max_examples=15, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["put", "delete", "commit"]),
                          st.integers(0, 30), st.binary(min_size=0, max_size=6)),
                min_size=1, max_size=80))
def test_durablekv_matches_memkv_and_survives_reopen(tmp_path_factory, ops):
    """Acceptance property: the same op sequence applied to MemKV and
    DurableKV yields identical get/scan results — before close, and
    byte-identical again after close + reopen from disk."""
    d = str(tmp_path_factory.mktemp("kv"))
    ref = MemKV(memtable_limit=7)
    kv = DurableKV(d, memtable_limit=7, sync="none")
    epoch = 0
    for op, ki, v in ops:
        k = f"{ki:04d}".encode()
        if op == "put":
            ref.put(k, v)
            kv.put(k, v)
        elif op == "delete":
            ref.delete(k)
            kv.delete(k)
        else:
            epoch += 1
            kv.commit_epoch(epoch)
    keys = [f"{i:04d}".encode() for i in range(31)]
    assert [kv.get(k) for k in keys] == [ref.get(k) for k in keys]
    assert list(kv.scan(b"")) == list(ref.scan(b""))
    assert list(kv.scan(b"001")) == list(ref.scan(b"001"))
    kv.close()                                   # commits the open tail
    kv2 = DurableKV(d, sync="none")
    assert [kv2.get(k) for k in keys] == [ref.get(k) for k in keys]
    assert list(kv2.scan(b"")) == list(ref.scan(b""))
    kv2.close()


def test_commit_epoch_monotone_and_advance_durable(tmp_path):
    """Regression: a lagging engine (device mirror with a trailing
    counter) must not move the committed epoch backwards, and an epoch
    ADVANCE is recorded durably even when the wave carried no content."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=10**9, sync="none")
    kv.put(b"a", b"1")
    kv.commit_epoch(3)
    kv.commit_epoch(1)                 # lagging caller: clamped, no regress
    assert kv.last_epoch() == 3
    kv.commit_epoch(4)                 # content-free advance: still durable
    kv.close()
    kv2 = DurableKV(d, sync="none")
    assert kv2.last_epoch() == 4
    kv2.close()


def test_manifest_atomic_and_orphan_sweep(tmp_path):
    d = str(tmp_path)
    meta = MF.SegmentMeta(name="seg_000001.seg", level=2, records=10,
                          bytes=123, min_key=b"a".hex(), max_key=b"z".hex(),
                          bloom_k=7, bloom_bits=640)
    m = MF.Manifest(segments=[meta], next_seg=2, epoch=7,
                    device_epoch=5, pending_inval=["/a"])
    MF.store(d, m, sync=False)
    assert not os.path.exists(os.path.join(d, MF.MANIFEST_NAME + ".tmp"))
    m2 = MF.load(d)
    assert (m2.segments, m2.next_seg, m2.epoch, m2.device_epoch,
            m2.pending_inval) == ([meta], 2, 7, 5, ["/a"])
    assert m2.segment_names() == ["seg_000001.seg"]
    assert m2.level_counts() == {2: 1}
    open(os.path.join(d, "seg_000009.seg"), "wb").close()
    removed = MF.sweep_orphans(d, m2)
    assert removed == ["seg_000009.seg"]


# ---------------------------------------------------------------------------
# PathStore / ShardedPathStore over the durable tier
# ---------------------------------------------------------------------------
def _store_signature(store):
    """Byte-level signature of every Q1/Q3/Q4 surface the wiki exposes."""
    paths = store.all_paths()
    sig = {"paths": paths}
    sig["records"] = {p: R.encode(store.get(p)) for p in paths}
    sig["navigate"] = {p: [R.encode(r) for r in store.navigate(p)]
                       for p in paths}
    prefixes = sorted({"/" + P.segments(p)[0] for p in paths if p != "/"})
    sig["search"] = {pref: store.search(pref) for pref in prefixes}
    sig["contains"] = {tok: store.search_contains(tok)
                       for tok in ("rel", "zhou", "nothere")}
    return sig


def test_pipeline_built_sharded_durable_reopens_byte_identical(tmp_path):
    """A DurableKV-backed ShardedPathStore built by
    the construction pipeline can be closed and reopened from disk with
    byte-identical get/navigate/search results — zero re-ingestion."""
    root = str(tmp_path / "wiki")
    store = open_durable_store(root, n_shards=3, memtable_limit=64,
                               sync="none")
    docs, _ = generate_authtrace(AuthTraceConfig(n_docs=24, n_questions=4,
                                                 seed=11))
    pipe = ConstructionPipeline(PipelineConfig(), HeuristicOracle(),
                                store=store)
    pipe.bootstrap(docs)
    pipe.ingest(docs)
    assert store.durable
    before = _store_signature(store)
    assert len(before["paths"]) > 20
    store.close()

    # reopen picks up the persisted shard count (routing-compatible)
    reopened = open_durable_store(root, sync="none")
    assert reopened.n_shards == 3
    assert _store_signature(reopened) == before
    # the namespace really is spread over per-shard directories on disk
    shard_dirs = [n for n in sorted(os.listdir(root)) if n.startswith("shard_")]
    assert len(shard_dirs) == 3
    per_shard = [s.count() for s in reopened.shards]
    assert sum(per_shard) == len(before["paths"]) and max(per_shard) < sum(per_shard)
    reopened.close()


def test_host_only_durable_store_does_not_journal(tmp_path):
    """The WAL invalidation journal is attached only by a device
    consumer: a pipeline/host-only durable store must not accumulate an
    unbounded pending_invalidations list."""
    root = str(tmp_path / "wiki")
    store = open_durable_store(root, sync="none")
    docs, _ = generate_authtrace(AuthTraceConfig(n_docs=12, n_questions=2,
                                                 seed=3))
    pipe = ConstructionPipeline(PipelineConfig(), HeuristicOracle(),
                                store=store)
    pipe.bootstrap(docs)
    pipe.ingest(docs)
    assert pipe.bus.journal is None
    assert store.pending_invalidations() == []
    store.close()
    reopened = open_durable_store(root, sync="none")
    assert reopened.pending_invalidations() == []
    reopened.close()


def test_reopen_with_wrong_shard_count_refuses(tmp_path):
    root = str(tmp_path / "wiki")
    open_durable_store(root, n_shards=2, sync="none").close()
    with pytest.raises(ValueError, match="n_shards"):
        open_durable_store(root, n_shards=4, sync="none")


def test_single_shard_store_roundtrip(tmp_path):
    root = str(tmp_path / "solo")
    store = open_durable_store(root, sync="none")
    assert isinstance(store, PathStore) and isinstance(store.engine, DurableKV)
    store.put_record("/", R.DirRecord(name=""))
    store.put_record("/dim", R.DirRecord(name="dim"))
    store.put_record("/dim/leaf", R.FileRecord(name="leaf", text="payload"))
    store.flush()
    store.close()
    again = open_durable_store(root, sync="none")
    assert again.get("/dim/leaf").text == "payload"
    assert again.search("/dim") == ["/dim", "/dim/leaf"]
    assert again.search_contains("leaf") == ["/dim/leaf"]
    again.close()


def test_sync_mode_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv(W.SYNC_ENV, "none")
    kv = DurableKV(str(tmp_path / "kv"))
    assert kv._sync == "none"
    kv.close()
    monkeypatch.setenv(W.SYNC_ENV, "bogus")
    with pytest.raises(ValueError, match="sync mode"):
        DurableKV(str(tmp_path / "kv2"))


def test_wal_directory_cleanup_shapes(tmp_path):
    """The scratch layout smoke.sh sweeps: *.wal + *.seg under the store
    dir, nothing else leaking elsewhere."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=2, sync="none")
    for i in range(8):
        kv.put(f"k{i}".encode(), b"v")
    kv.commit_epoch(1)
    kv.close()
    names = sorted(os.listdir(d))
    assert WAL_NAME in names
    assert any(n.endswith(".seg") for n in names)
    shutil.rmtree(d)

# ---------------------------------------------------------------------------
# leveled compaction, bloom filters, block cache
# ---------------------------------------------------------------------------
import json
import struct

from repro_torch.storage.lsm import default_block_cache, resolve_level_ratio
from repro_torch.storage.sstable import (END_MAGIC, END_MAGIC_V1, MAGIC,
                                   SPARSE_EVERY, BlockCache, BloomFilter)


def _fill(kv, lo, hi, commit_epoch):
    for i in range(lo, hi):
        kv.put(f"k{i:05d}".encode(), f"v{i}".encode())
    kv.commit_epoch(commit_epoch)


def test_leveled_compaction_merges_only_triggering_level(tmp_path):
    """The online trigger merges the triggering
    level's run into ONE next-level segment and touches nothing else —
    asserted via per-level segment counts AND the untouched segment's
    file name surviving the merge."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none", level_ratio=3)
    # two spills: L0 = 2 (below the ratio-3 trigger)
    _fill(kv, 0, 4, 1)
    _fill(kv, 4, 8, 2)
    assert kv.level_counts() == {0: 2}
    # third spill trips the trigger: L0's 3-segment run merges into ONE
    # L1 segment; nothing else existed, so the tree is exactly {1: 1}
    _fill(kv, 8, 12, 3)
    assert kv.level_counts() == {1: 1}
    l1_name = kv._manifest.segments[0].name
    # two more spills: L0 grows beside the L1 segment, no trigger
    _fill(kv, 12, 16, 4)
    _fill(kv, 16, 20, 5)
    assert kv.level_counts() == {0: 2, 1: 1}
    # the next spill merges ONLY level 0: the L1 segment file must
    # survive untouched (same name — it was not rewritten), L1 grows to 2
    _fill(kv, 20, 24, 6)
    assert kv.level_counts() == {1: 2}
    survivors = [m.name for m in kv._manifest.segments if m.level == 1]
    assert l1_name in survivors, "merge rewrote a non-triggering level"
    # every key remains visible through the tree
    assert kv.get(b"k00000") == b"v0"
    assert kv.get(b"k00023") == b"v23"
    assert len(dict(kv.scan(b"k"))) == 24
    kv.close()


def test_leveled_cascade_and_major_compact(tmp_path):
    """ratio-2 store with a tiny partition target cascades beyond L1 as
    the byte caps overflow; ``compact()`` then collapses the whole tree
    into one bottom level of disjoint partitions."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=2, sync="none", level_ratio=2,
                   segment_target_bytes=32)
    for w in range(8):
        _fill(kv, 2 * w, 2 * w + 2, w + 1)
    counts = kv.level_counts()
    assert sum(counts.values()) >= 1 and max(counts) >= 2, counts
    assert len(dict(kv.scan(b"k"))) == 16
    kv.compact()
    counts = kv.level_counts()
    assert len(counts) == 1, counts          # one (bottom) level remains
    assert max(counts) >= 2                  # stayed at the bottom level
    # ... and its partitions are disjoint, range-known, and findable
    metas = [m for m in kv._manifest.segments]
    spans = sorted((bytes.fromhex(m.min_key), bytes.fromhex(m.max_key))
                   for m in metas)
    assert all(spans[i][0] > spans[i - 1][1] for i in range(1, len(spans)))
    assert len(dict(kv.scan(b"k"))) == 16
    assert kv.get(b"k00000") == b"v0" and kv.get(b"k00015") == b"v15"
    kv.close()


def test_tombstones_survive_level_merge_until_bottom(tmp_path):
    """A tombstone must out-live any level merge while deeper (older)
    data still holds the key, and only disappear once the merge output
    is the oldest data in the store."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=2, sync="none", level_ratio=2)
    _fill(kv, 0, 2, 1)
    _fill(kv, 2, 4, 2)                       # cascade → L1 holds k0..k3
    assert kv.level_counts() == {1: 1}
    kv.delete(b"k00000")
    kv.put(b"x", b"1")
    kv.commit_epoch(3)                       # spill: tombstone now in L0
    _fill(kv, 4, 6, 4)                       # L0=2 → merges into L1 (older L1 seg exists)
    assert kv.get(b"k00000") is None, "tombstone dropped above older data"
    assert b"k00000" not in dict(kv.scan(b"k"))
    kv.close()
    kv2 = DurableKV(d, sync="none", level_ratio=2)
    assert kv2.get(b"k00000") is None
    kv2.compact()                            # bottom merge may now drop it
    assert kv2.get(b"k00000") is None
    kv2.close()


def _abandon(kv):
    """Drop a wounded engine without close(): release file handles the
    way a dead process would (no commit, no manifest write)."""
    try:
        kv._wal._f.close()
    except Exception:
        pass
    for t in kv._tables.values():
        try:
            t.close()
        except Exception:
            pass


def _live_seg_names(kv):
    """Every .seg name the manifest considers paid-for: live segments
    plus a paused merge's recorded outputs."""
    live = set(kv._manifest.segment_names())
    if kv._manifest.compaction is not None:
        live.update(o.name for o in kv._manifest.compaction.outputs)
    return live


# the durability-critical IO sites a merge/spill walks through (WAL
# sites are excluded on purpose: these schedules crash *after* the
# wave's group commit, so the expected recovered content is exact)
_MERGE_SITES = frozenset({"segment.write", "manifest.write",
                          "manifest.replace"})


@pytest.mark.parametrize("mode", ["fail", "torn"])
def test_crash_during_partitioned_merge_every_boundary(tmp_path, mode):
    """The crash tests, parametrized over partitioned merges: crash at EVERY segment-write / manifest-write /
    manifest-swap boundary of a wave whose spill triggers a
    multi-partition L0→L1 merge — cleanly or with a torn prefix — and
    recovery must lose nothing, resurrect nothing, and leave no
    unreferenced .seg behind.  The schedule length is discovered with a
    counting plan first, so every boundary is exercised, not a
    hand-picked few."""
    def build(d):
        return DurableKV(d, memtable_limit=2, sync="none", level_ratio=2,
                         segment_target_bytes=32)

    def preload(kv):
        _fill(kv, 0, 2, 1)
        _fill(kv, 2, 4, 2)                   # L0 merge → partitioned L1
        _fill(kv, 4, 6, 3)                   # L0 = 1 beside L1

    # pass 0: count the faultable ops in the triggering wave
    kv = build(str(tmp_path / "count"))
    preload(kv)
    with FPS.armed(FPS.FailPlan(crash_at=0, sites=_MERGE_SITES)) as counter:
        _fill(kv, 6, 8, 4)                   # spill + partitioned merge
    kv.close()
    n_ops = len(counter.hits)
    # spill (seg + manifest) + multi-partition merge (≥ 2 segs + manifest)
    assert n_ops >= 5, counter.hits

    expected = {f"k{i:05d}".encode(): f"v{i}".encode() for i in range(8)}
    for nth in range(1, n_ops + 1):
        d = str(tmp_path / f"kv_{mode}_{nth}")
        kv = build(d)
        preload(kv)
        with FPS.armed(FPS.FailPlan(crash_at=nth, mode=mode,
                                    sites=_MERGE_SITES)):
            with pytest.raises(FPS.InjectedCrash):
                _fill(kv, 6, 8, 4)
        _abandon(kv)

        kv2 = build(d)
        assert dict(kv2.scan(b"k")) == expected, f"boundary {nth}"
        for k, v in expected.items():
            assert kv2.get(k) == v
        # recovery swept everything the manifest does not pay for
        on_disk = {n for n in os.listdir(d) if n.endswith(".seg")}
        assert on_disk == _live_seg_names(kv2), f"boundary {nth}"
        # and the store still moves forward after the crash
        _fill(kv2, 8, 10, 5)
        assert len(dict(kv2.scan(b"k"))) == 10
        kv2.close()


def test_budget_pause_and_resume(tmp_path):
    """A merge that exhausts ``compact_budget_bytes`` pauses resumably:
    the completed partitions + resume key are durable in the manifest,
    reads stay correct off the still-live inputs, ``compact_debt``
    reports the remainder, and later commit boundaries finish the merge
    and drain the debt to zero."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none", level_ratio=2,
                   segment_target_bytes=32, compact_budget_bytes=150)
    _fill(kv, 0, 4, 1)
    _fill(kv, 4, 8, 2)                       # L0=2 → merge, pauses on budget
    st = kv._manifest.compaction
    assert st is not None and st.next_key and st.outputs
    assert kv.compact_debt() > 0
    # the paused state is DURABLE, not just in memory
    with open(os.path.join(d, MF.MANIFEST_NAME), encoding="utf-8") as f:
        on_disk = json.load(f)
    assert on_disk["compaction"] is not None
    assert on_disk["compaction"]["next_key"] == st.next_key
    # reads while paused: inputs still live, view identical
    expected = {f"k{i:05d}".encode(): f"v{i}".encode() for i in range(8)}
    assert dict(kv.scan(b"k")) == expected
    # epoch-advancing commits drain the debt a budget-slice at a time
    epoch, waves = 2, 0
    while kv.compact_debt() > 0:
        epoch += 1
        kv.commit_epoch(epoch)
        assert kv.last_compact_bytes <= 150 + 200, \
            "a resume slice blew through the budget"
        waves += 1
        assert waves < 50, "debt never drained"
    assert waves >= 1
    assert kv._manifest.compaction is None
    assert dict(kv.scan(b"k")) == expected
    # the settled tree keeps the tentpole invariant: every level ≥ 1 is
    # a partitioned (range-disjoint, binary-searchable) view
    assert all(m.level >= 1 for m in kv._manifest.segments)
    for view in kv._levels:
        assert view.partitioned, f"level {view.level} fell back to probe-all"
    kv.close()


def test_budget_pause_survives_reopen_and_resumes(tmp_path):
    """The resumable-merge state round-trips a clean close/reopen: the
    reopened store still owes the debt and finishes the same merge."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none", level_ratio=2,
                   segment_target_bytes=32, compact_budget_bytes=150)
    _fill(kv, 0, 4, 1)
    _fill(kv, 4, 8, 2)
    assert kv._manifest.compaction is not None
    paused_outputs = [o.name for o in kv._manifest.compaction.outputs]
    kv.close()

    kv2 = DurableKV(d, memtable_limit=4, sync="none", level_ratio=2,
                    segment_target_bytes=32, compact_budget_bytes=150)
    st = kv2._manifest.compaction
    assert st is not None
    assert [o.name for o in st.outputs] == paused_outputs, \
        "recovery swept a paused merge's paid-for outputs"
    assert kv2.compact_debt() > 0
    epoch = 2
    while kv2.compact_debt() > 0:
        epoch += 1
        kv2.commit_epoch(epoch)
        assert epoch < 50
    assert dict(kv2.scan(b"k")) == {f"k{i:05d}".encode(): f"v{i}".encode()
                                    for i in range(8)}
    kv2.close()


@pytest.mark.parametrize("mode", ["fail", "torn"])
def test_crash_during_resumed_merge_every_boundary(tmp_path, mode):
    """Mid-resume crash points: pause a merge on
    budget, then crash the RESUMING wave at every IO boundary.  Recovery
    must keep the recorded pre-pause partitions, re-merge only from the
    resume key, and still converge to the oracle view."""
    def build(d):
        return DurableKV(d, memtable_limit=4, sync="none", level_ratio=2,
                         segment_target_bytes=32, compact_budget_bytes=150)

    def pause(kv):
        _fill(kv, 0, 4, 1)
        _fill(kv, 4, 8, 2)
        assert kv._manifest.compaction is not None, "merge did not pause"

    # count the resuming wave's faultable ops
    kv = build(str(tmp_path / "count"))
    pause(kv)
    with FPS.armed(FPS.FailPlan(crash_at=0, sites=_MERGE_SITES)) as counter:
        epoch = 3
        while kv._manifest.compaction is not None:
            kv.commit_epoch(epoch)
            epoch += 1
    kv.close()
    n_ops = len(counter.hits)
    assert n_ops >= 2, counter.hits

    expected = {f"k{i:05d}".encode(): f"v{i}".encode() for i in range(8)}
    for nth in range(1, n_ops + 1):
        d = str(tmp_path / f"kv_{mode}_{nth}")
        kv = build(d)
        pause(kv)
        with FPS.armed(FPS.FailPlan(crash_at=nth, mode=mode,
                                    sites=_MERGE_SITES)):
            with pytest.raises(FPS.InjectedCrash):
                epoch = 3
                while kv._manifest.compaction is not None:
                    kv.commit_epoch(epoch)
                    epoch += 1
        _abandon(kv)

        kv2 = build(d)
        assert dict(kv2.scan(b"k")) == expected, f"resume boundary {nth}"
        on_disk = {n for n in os.listdir(d) if n.endswith(".seg")}
        assert on_disk == _live_seg_names(kv2), f"resume boundary {nth}"
        epoch = 20                           # drain the debt for real
        while kv2.compact_debt() > 0:
            kv2.commit_epoch(epoch)
            epoch += 1
            assert epoch < 90
        assert dict(kv2.scan(b"k")) == expected
        assert kv2._manifest.compaction is None
        kv2.close()


def test_major_compact_abandons_paused_merge(tmp_path):
    """``compact()`` supersedes a paused merge: the recorded outputs are
    deleted (they are copies of still-live inputs), the state clears,
    and the full view survives in bottom-level partitions."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none", level_ratio=2,
                   segment_target_bytes=32, compact_budget_bytes=150)
    _fill(kv, 0, 4, 1)
    _fill(kv, 4, 8, 2)
    st = kv._manifest.compaction
    assert st is not None
    orphan_candidates = [o.name for o in st.outputs]
    kv.compact()
    assert kv._manifest.compaction is None
    on_disk = {n for n in os.listdir(d) if n.endswith(".seg")}
    assert not (on_disk & set(orphan_candidates)), \
        "abandoned merge outputs leaked"
    assert on_disk == set(kv._manifest.segment_names())
    assert dict(kv.scan(b"k")) == {f"k{i:05d}".encode(): f"v{i}".encode()
                                   for i in range(8)}
    assert kv.compact_debt() == 0
    kv.close()


def test_bloom_filter_no_false_negatives_and_fpr():
    """Property: every inserted key passes; the false-positive rate on
    disjoint probes stays near the design point (~0.8% at 10 bits/key —
    assert a generous < 3%)."""
    present = [f"in:{i}".encode() for i in range(2000)]
    bf = BloomFilter.build(present, bits_per_key=10)
    assert all(bf.may_contain(k) for k in present), "false negative"
    absent = [f"out:{i}".encode() for i in range(10000)]
    fpr = sum(bf.may_contain(k) for k in absent) / len(absent)
    assert fpr < 0.03, f"FPR {fpr:.4f} too high for 10 bits/key"


@given(st.lists(st.binary(min_size=0, max_size=12), unique=True,
                min_size=1, max_size=200))
@settings(max_examples=30, deadline=None)
def test_bloom_filter_never_false_negative_property(keys):
    bf = BloomFilter.build(keys, bits_per_key=10)
    assert all(bf.may_contain(k) for k in keys)


def test_durablekv_bloom_skips_segments_on_miss(tmp_path):
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none", level_ratio=100)
    for w in range(4):
        _fill(kv, 4 * w, 4 * w + 4, w + 1)
    assert kv.level_counts() == {0: 4}
    base = kv.op_counts().get("bloom_neg", 0)
    for i in range(50):
        assert kv.get(f"absent{i}".encode()) is None
    negs = kv.op_counts()["bloom_neg"] - base
    # 50 misses x 4 segments = 200 probes; ~all should be bloom-skipped
    assert negs >= 190, f"only {negs}/200 probes bloom-skipped"
    kv.close()


def test_block_cache_hit_accounting_and_eviction(tmp_path):
    cache = BlockCache(capacity_bytes=1 << 20)
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=64, sync="none", block_cache=cache)
    _fill(kv, 0, 64, 1)                      # one spilled segment
    assert kv.level_counts() == {0: 1}
    assert kv.get(b"k00003") == b"v3"        # first touch parses the block
    c0 = kv.op_counts()
    assert c0.get("cache_miss", 0) >= 1
    for _ in range(10):
        assert kv.get(b"k00003") == b"v3"
    c1 = kv.op_counts()
    assert c1["cache_hit"] >= c0.get("cache_hit", 0) + 10
    assert c1["cache_miss"] == c0["cache_miss"]   # same block, no re-parse
    assert cache.hits >= 10 and len(cache) >= 1
    # compaction closes the old segment -> its blocks are evicted
    kv.compact()
    assert all(k[0].endswith(kv._manifest.segments[0].name)
               for k in cache._d), "stale blocks survived segment delete"
    kv.close()

    # eviction under a tiny budget: walk many blocks, stay under capacity
    tiny = BlockCache(capacity_bytes=600)
    kv2 = DurableKV(str(tmp_path / "kv2"), memtable_limit=256, sync="none",
                    block_cache=tiny)
    _fill(kv2, 0, 256, 1)
    for i in range(0, 256, SPARSE_EVERY):    # one get per index block
        assert kv2.get(f"k{i:05d}".encode()) == f"v{i}".encode()
    assert tiny.used_bytes() <= 600
    assert len(tiny) < 256 // SPARSE_EVERY, "nothing was ever evicted"
    kv2.close()


def test_block_cache_disabled_by_env_zero(monkeypatch):
    monkeypatch.setenv("REPRO_BLOCK_CACHE_BYTES", "0")
    assert default_block_cache() is None
    monkeypatch.setenv("REPRO_BLOCK_CACHE_BYTES", "1024")
    c = default_block_cache()
    assert isinstance(c, BlockCache) and c.capacity == 1024
    monkeypatch.setenv("REPRO_LEVEL_RATIO", "1")
    with pytest.raises(ValueError, match="level_ratio"):
        resolve_level_ratio()


def test_pr3_manifest_and_segments_migrate(tmp_path):
    """A format-1 store (format-1 manifest naming bare
    segment files, v1 segments without blooms) opens as all-level-0,
    serves reads, and migrates to the leveled format-2 manifest on the
    first compaction — round-tripped through a reopen."""
    d = str(tmp_path / "kv")
    os.makedirs(d)
    # v1 bytes via the compatibility writer (bloom_bits_per_key=0)
    write_sstable(os.path.join(d, "seg_000001.seg"),
                  [(b"a", b"1"), (b"b", b"2")], sync=False,
                  bloom_bits_per_key=0)
    write_sstable(os.path.join(d, "seg_000002.seg"),
                  [(b"b", b"22"), (b"c", b"3")], sync=False,
                  bloom_bits_per_key=0)
    with open(os.path.join(d, MF.MANIFEST_NAME), "w", encoding="utf-8") as f:
        json.dump({"format": 1,
                   "segments": ["seg_000001.seg", "seg_000002.seg"],
                   "next_seg": 3, "epoch": 7, "device_epoch": 7,
                   "pending_inval": []}, f)

    kv = DurableKV(d, sync="none", memtable_limit=4)
    assert kv.last_epoch() == 7
    assert kv.level_counts() == {0: 2}       # format-1 segments open at level 0
    for meta, seg in kv._read_order:
        assert seg.bloom is None and meta.bloom_bits == 0
    assert kv.get(b"a") == b"1"
    assert kv.get(b"b") == b"22"             # newer segment shadows older
    assert dict(kv.scan(b"")) == {b"a": b"1", b"b": b"22", b"c": b"3"}
    kv.compact()                             # first manifest write migrates
    kv.close()

    with open(os.path.join(d, MF.MANIFEST_NAME), encoding="utf-8") as f:
        o = json.load(f)
    assert o["format"] == MF.FORMAT == 3
    assert all(isinstance(s, dict) and "level" in s for s in o["segments"])
    assert o["compaction"] is None
    kv2 = DurableKV(d, sync="none")
    assert kv2.last_epoch() == 7
    assert dict(kv2.scan(b"")) == {b"a": b"1", b"b": b"22", b"c": b"3"}
    # post-migration segments carry blooms at the default budget
    assert all(seg.bloom is not None for _, seg in kv2._read_order)
    kv2.close()


def test_format2_manifest_migrates_to_format3(tmp_path):
    """A leveled (format-2) manifest opens with no pending merge
    and the first manifest write migrates it to format 3 with an
    explicit ``compaction: null`` field."""
    d = str(tmp_path / "kv")
    os.makedirs(d)
    write_sstable(os.path.join(d, "seg_000001.seg"),
                  [(b"a", b"1"), (b"b", b"2")], sync=False)
    with open(os.path.join(d, MF.MANIFEST_NAME), "w", encoding="utf-8") as f:
        json.dump({"format": 2,
                   "segments": [{"name": "seg_000001.seg", "level": 1,
                                 "records": 2, "bytes": 64,
                                 "min_key": b"a".hex(),
                                 "max_key": b"b".hex(),
                                 "bloom_k": 0, "bloom_bits": 0}],
                   "next_seg": 2, "epoch": 3, "device_epoch": 3,
                   "pending_inval": []}, f)

    kv = DurableKV(d, sync="none", memtable_limit=4)
    assert kv._manifest.compaction is None   # format 2 ⇒ nothing pending
    assert kv.level_counts() == {1: 1}
    assert kv.get(b"a") == b"1"
    for k in (b"c", b"d", b"e", b"f"):
        kv.put(k, b"3")
    kv.commit_epoch(4)                       # spill ⇒ first manifest write
    kv.close()

    with open(os.path.join(d, MF.MANIFEST_NAME), encoding="utf-8") as f:
        o = json.load(f)
    assert o["format"] == 3 and "compaction" in o
    kv2 = DurableKV(d, sync="none")
    assert dict(kv2.scan(b"")) == {b"a": b"1", b"b": b"2", b"c": b"3",
                                   b"d": b"3", b"e": b"3", b"f": b"3"}
    kv2.close()


def test_block_cache_no_stale_blocks_across_store_generations(tmp_path):
    """A shared BlockCache must never serve a dead
    generation's blocks.  Recreating a store at the SAME directory (same
    segment file names) with different values — the shape of a
    crash-restore or a test harness reusing a path — must read the new
    bytes even when the old generation's blocks are still cached."""
    d = str(tmp_path / "kv")
    cache = default_block_cache(1 << 20)
    kv = DurableKV(d, memtable_limit=2, sync="none", block_cache=cache)
    _fill(kv, 0, 2, 1)                       # spill → seg_000001.seg
    assert kv.get(b"k00000") == b"v0"        # populate the cache
    assert len(cache) > 0
    _abandon(kv)                             # die without close()

    shutil.rmtree(d)                         # new lineage, same path
    kv2 = DurableKV(d, memtable_limit=2, sync="none", block_cache=cache)
    kv2.put(b"k00000", b"NEW")
    kv2.put(b"k00001", b"NEW")
    kv2.commit_epoch(1)                      # spill → seg_000001.seg again
    assert [m.name for m in kv2._manifest.segments] == ["seg_000001.seg"]
    assert kv2.get(b"k00000") == b"NEW", \
        "shared BlockCache served a stale block from a dead generation"
    assert dict(kv2.scan(b"k")) == {b"k00000": b"NEW", b"k00001": b"NEW"}
    kv2.close()


@settings(max_examples=10, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["put", "delete", "commit"]),
                          st.integers(0, 30), st.binary(min_size=0, max_size=6)),
                min_size=20, max_size=120))
def test_multilevel_durablekv_matches_memkv(tmp_path_factory, ops):
    """MemKV parity under an aggressively leveled tree: tiny memtable +
    ratio 2 force frequent spills and cascading merges, with the shared
    block cache attached — then byte-identical again after reopen."""
    d = str(tmp_path_factory.mktemp("kv"))
    ref = MemKV(memtable_limit=7)
    kv = DurableKV(d, memtable_limit=3, sync="none", level_ratio=2,
                   block_cache=BlockCache(1 << 16))
    epoch = 0
    for op, ki, v in ops:
        k = f"{ki:04d}".encode()
        if op == "put":
            ref.put(k, v)
            kv.put(k, v)
        elif op == "delete":
            ref.delete(k)
            kv.delete(k)
        else:
            epoch += 1
            kv.commit_epoch(epoch)
    keys = [f"{i:04d}".encode() for i in range(31)]
    assert [kv.get(k) for k in keys] == [ref.get(k) for k in keys]
    assert list(kv.scan(b"")) == list(ref.scan(b""))
    kv.close()
    kv2 = DurableKV(d, memtable_limit=3, sync="none", level_ratio=2)
    assert [kv2.get(k) for k in keys] == [ref.get(k) for k in keys]
    assert list(kv2.scan(b"")) == list(ref.scan(b""))
    kv2.close()


def test_segment_footer_matches_documented_layout(tmp_path):
    """The docs/STORAGE.md byte layout is asserted
    against a real segment file — v2 footer ``<QQIIIQ`` + WEND2 and the
    v1 compatibility footer ``<QII`` + WEND1 — by parsing raw bytes with
    nothing but the documented offsets."""
    items = [(f"k{i:03d}".encode(), f"v{i}".encode()) for i in range(40)]

    p2 = str(tmp_path / "v2.seg")
    stats = write_sstable(p2, items, sync=False, bloom_bits_per_key=10)
    raw = open(p2, "rb").read()
    assert raw[:6] == MAGIC == b"WSEG1\n"
    assert raw[-6:] == END_MAGIC == b"WEND2\n"
    footer = struct.Struct("<QQIIIQ")               # as documented
    (index_off, bloom_off, n_index, n_records,
     bloom_k, bloom_nbits) = footer.unpack(raw[-6 - footer.size:-6])
    assert n_records == 40
    assert n_index == (40 + SPARSE_EVERY - 1) // SPARSE_EVERY == 3
    assert bloom_k == stats.bloom_k and bloom_nbits == stats.bloom_nbits
    assert bloom_nbits == 40 * 10                   # n * bits_per_key
    # section order and sizes: data | index | bloom | footer
    assert 6 < index_off < bloom_off < len(raw)
    assert bloom_off + (bloom_nbits + 7) // 8 == len(raw) - footer.size - 6
    # first record at the documented offset: key_len u32 | val_len u32 | ...
    klen, vlen = struct.unpack_from("<II", raw, 6)
    assert raw[14:14 + klen] == b"k000" and klen == 4
    assert raw[14 + klen:14 + klen + vlen] == b"v0"
    # first index entry points back at the first record
    iklen, = struct.unpack_from("<I", raw, index_off)
    ikey = raw[index_off + 4: index_off + 4 + iklen]
    ioff, = struct.unpack_from("<Q", raw, index_off + 4 + iklen)
    assert ikey == b"k000" and ioff == 6
    assert stats.file_bytes == len(raw)

    p1 = str(tmp_path / "v1.seg")
    write_sstable(p1, items, sync=False, bloom_bits_per_key=0)
    raw1 = open(p1, "rb").read()
    assert raw1[-6:] == END_MAGIC_V1 == b"WEND1\n"
    f1 = struct.Struct("<QII")
    index_off1, n_index1, n_records1 = f1.unpack(raw1[-6 - f1.size:-6])
    assert (n_records1, n_index1) == (40, 3)
    # v1 == v2 minus the bloom section and the wider footer
    assert raw1[:index_off1] == raw[:index_off]
    t = SSTable(p1)
    assert t.bloom is None and t.get(b"k007") == b"v7"
    t.close()


# ---------------------------------------------------------------------------
# on-disk parity with the reference package, store by store
# ---------------------------------------------------------------------------
def _packages():
    """(name, records module, WikiWriter, open_durable_store) of each
    package; the reference's ``repro.storage`` is the same tier's
    original."""
    from repro.core import records as JR
    from repro.core.consistency import WikiWriter as JWriter
    from repro.storage import open_durable_store as jopen
    from repro_torch.core.consistency import WikiWriter
    return {"ref": (JR, JWriter, jopen), "port": (R, WikiWriter, open_durable_store)}


def _write_history(pkg, root: str, n_shards: int, seed: int) -> None:
    """One seeded history through a package's writer (clock fixed, so
    both packages write the same bytes): admits, unlinks and updates in
    waves, each wave committed at its epoch, invalidations journaled,
    a device epoch marked, spills and leveled merges forced by a small
    memtable and segment target, then a clean close."""
    Rm, Writer, opener = pkg
    rng = random.Random(seed)
    store = opener(root, n_shards=n_shards, sync="none", memtable_limit=12,
                   level_ratio=2, segment_target_bytes=512)
    w = Writer(store, clock=lambda: 0.0)
    w.ensure_root("root")
    live = []
    for epoch in range(1, 7):
        for _ in range(rng.randint(4, 9)):
            d = f"/d{rng.randrange(3)}"
            if store.get(d) is None:
                w.admit(d, Rm.DirRecord(name=d[1:], summary=f"dim {d}"))
            path = f"{d}/e{rng.randrange(40):02d}"
            w.admit(path, Rm.FileRecord(name=P.basename(path), text=f"{epoch} {rng.random():.6f}"))
            store.journal_invalidation(path)
            if path not in live:
                live.append(path)
        if live and rng.random() < 0.6:
            victim = live.pop(rng.randrange(len(live)))
            w.unlink(victim)
            store.journal_invalidation(victim)
        if epoch == 3:
            store.mark_device_epoch(epoch)
        store.commit_epoch(epoch)
        if epoch == 5:
            store.compact()
    store.close()


def _view(pkg, root: str) -> dict:
    """Everything a reopened store answers: every record (bytes), the
    raw key-value scan of each shard, the epochs, the pending journal."""
    store = pkg[2](root, sync="none")
    paths = store.all_paths()
    shards = getattr(store, "shards", [store])
    out = {"paths": paths,
           "get": [None if r is None else r.to_bytes()
                   for r in (store.get(p) for p in paths + ["/d0/absent", "/zz"])],
           "scan": [list(s.engine.scan(b"")) for s in shards],
           "last_epoch": store.last_epoch(),
           "device_epoch": [s.engine.device_epoch() for s in shards],
           "pending": store.pending_invalidations()}
    store.close()
    return out


def _files(root: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            full = os.path.join(dirpath, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_store_written_by_one_package_reopens_in_the_other(tmp_path, writer, reader, n_shards):
    pkgs = _packages()
    root = str(tmp_path / "wiki")
    _write_history(pkgs[writer], root, n_shards, seed=13 + n_shards)
    want = _view(pkgs[writer], root)
    got = _view(pkgs[reader], root)
    assert got == want
    assert want["last_epoch"] == 6 and want["pending"]
    assert want["device_epoch"] == [3] * n_shards
    assert any(want["scan"])


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("seed", [4, 21])
def test_same_history_writes_byte_identical_files(tmp_path, seed, n_shards):
    pkgs = _packages()
    roots = {name: str(tmp_path / name) for name in pkgs}
    for name, pkg in pkgs.items():
        _write_history(pkg, roots[name], n_shards, seed)
    ref, port = _files(roots["ref"]), _files(roots["port"])
    assert sorted(port) == sorted(ref)
    assert any(n.endswith(".seg") for n in ref) and any("MANIFEST" in n for n in ref)
    for name in ref:
        assert port[name] == ref[name], name

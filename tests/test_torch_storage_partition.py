"""Key-range-partitioned levels of the port's storage tier: binary-searched
point reads that probe exactly one segment per level ≥ 1, range-pruned
k-way-merge scans with correct tombstone semantics across levels, the
compaction backpressure budget, and the ``seg_probe``/``compact_debt``
telemetry plumbed through the engine stats surface.

The probe-count tests hand-craft a three-level partitioned store by
writing segment files + a format-3 manifest directly: the compaction
machinery (covered in test_torch_storage.py) would sink tiny fixtures to one
bottom level, while the read-path acceptance needs a *deep* tree with a
known shape — levels are a manifest property, so building one is
legitimate store surgery, not a bypass.
"""
import json
import os

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core import records as R
from repro_torch.core.consistency import WikiWriter
from repro_torch.core.engine import (D_COMPACT_DEBT, D_SEG_PROBE, HostEngine)
from repro_torch.core.store import MemKV
from repro_torch import obs
from repro_torch.storage import DurableKV, open_durable_store, write_sstable
from repro_torch.storage import manifest as MF
from repro_torch.storage.sstable import TOMBSTONE


def _k(i: int) -> bytes:
    return f"k{i:04d}".encode()


def _write_level(d, manifest, items, level, n_parts):
    """Split ``items`` into ``n_parts`` contiguous partitions, write each
    as a segment file, and append range-accurate metas to ``manifest``."""
    per = (len(items) + n_parts - 1) // n_parts
    for p in range(n_parts):
        chunk = items[p * per:(p + 1) * per]
        if not chunk:
            continue
        name = manifest.alloc_segment()
        stats = write_sstable(os.path.join(d, name), chunk, sync=False,
                              bloom_bits_per_key=0)
        manifest.segments.append(MF.SegmentMeta(
            name=name, level=level, records=stats.n_records,
            bytes=stats.file_bytes, min_key=stats.min_key.hex(),
            max_key=stats.max_key.hex(), bloom_k=0, bloom_bits=0))


def _three_level_store(tmp_path):
    """A 3-level partitioned store with a known shadowing pattern over
    keys k0000..k0059: i ≡ 0 (mod 3) newest at L1, i ≡ 1 at L2, every
    key oldest at L3 — so L1/L2 shadow L3 for their residues and only
    i ≡ 2 keys fall all the way through.  Blooms are disabled so every
    candidate segment really is probed."""
    d = str(tmp_path / "kv")
    os.makedirs(d)
    m = MF.Manifest(epoch=1)
    _write_level(d, m, [(_k(i), b"L3") for i in range(60)], level=3,
                 n_parts=4)
    _write_level(d, m, [(_k(i), b"L2") for i in range(60) if i % 3 == 1],
                 level=2, n_parts=2)
    _write_level(d, m, [(_k(i), b"L1") for i in range(60) if i % 3 == 0],
                 level=1, n_parts=2)
    MF.store(d, m, sync=False)
    kv = DurableKV(d, sync="none")
    assert kv.level_counts() == {1: 2, 2: 2, 3: 4}
    assert all(v.partitioned for v in kv._levels), \
        "a handcrafted level fell back to probe-all"
    return kv


def _probe_delta(kv, keys):
    base = kv.op_counts().get("seg_probe", 0)
    out = [kv.get(k) for k in keys]
    return out, kv.op_counts().get("seg_probe", 0) - base


# ---------------------------------------------------------------------------
# the tentpole acceptance: one probe per level ≥ 1
# ---------------------------------------------------------------------------
def test_point_read_probes_exactly_one_segment_per_level(tmp_path):
    """On a ≥3-level partitioned store, a cold point
    read probes exactly ONE segment per level ≥ 1 (manifest key ranges +
    per-level binary search), shown by the ``seg_probe`` counter."""
    kv = _three_level_store(tmp_path)
    # keys that miss L1 and L2 but sit inside every level's key range:
    # exactly 3 probes each (1 per level), hit lands at L3
    vals, delta = _probe_delta(kv, [_k(5), _k(23), _k(41)])
    assert vals == [b"L3"] * 3
    assert delta == 3 * 3, f"expected 1 probe/level, counted {delta}"
    # a key shadowed at L1 stops there: exactly 1 probe
    vals, delta = _probe_delta(kv, [_k(9)])
    assert vals == [b"L1"] and delta == 1
    # shadowed at L2: probes L1 (range hit, key miss) then L2
    vals, delta = _probe_delta(kv, [_k(22)])
    assert vals == [b"L2"] and delta == 2
    # a key outside every partition's range probes NOTHING
    vals, delta = _probe_delta(kv, [b"zzz"])
    assert vals == [None] and delta == 0
    kv.close()


def test_flat_reads_probe_every_shallower_segment(tmp_path):
    """The ``flat_reads`` A/B switch really is the pre-partitioned read
    path: the same miss-at-shallow-levels key probes every L1/L2 segment
    plus at least one L3 partition instead of one per level."""
    kv = _three_level_store(tmp_path)
    _, part = _probe_delta(kv, [_k(5)])
    assert part == 3
    kv.set_flat_reads(True)
    assert not any(v.partitioned for v in kv._levels)
    _, flat = _probe_delta(kv, [_k(5)])
    assert flat >= 2 + 2 + 1                # all of L1+L2, ≥1 of L3
    assert flat > part
    kv.set_flat_reads(False)
    _, again = _probe_delta(kv, [_k(5)])
    assert again == 3                       # the toggle round-trips
    kv.close()


# ---------------------------------------------------------------------------
# scan across partitioned levels
# ---------------------------------------------------------------------------
def test_scan_first_seen_wins_across_partitioned_levels(tmp_path):
    """The k-way merge keeps level order: the shallowest version of each
    key wins, partitions of one level interleave seamlessly."""
    kv = _three_level_store(tmp_path)
    got = dict(kv.scan(b"k"))
    want = {_k(i): (b"L1" if i % 3 == 0 else b"L2" if i % 3 == 1 else b"L3")
            for i in range(60)}
    assert got == want
    # range-pruning: a narrow prefix skips non-overlapping partitions
    base = kv.op_counts().get("scan_skip", 0)
    sub = dict(kv.scan(_k(7)[:5]))          # prefix b"k0007"
    assert sub == {_k(7): b"L2"}
    assert kv.op_counts().get("scan_skip", 0) > base
    kv.close()


def test_tombstones_interleaved_across_partitioned_levels(tmp_path):
    """Deletes layered above partitioned levels: scan and get drop the
    deleted keys, the tombstones themselves survive level merges while a
    deeper level remains, and a major compact finally drops them."""
    d = str(tmp_path / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none", level_ratio=2,
                   segment_target_bytes=32)
    for i in range(8):
        kv.put(_k(i), f"v{i}".encode())
    kv.commit_epoch(1)
    kv.compact()                             # partitioned bottom level
    bottom = max(m.level for m in kv._manifest.segments)
    assert bottom >= 1
    assert sum(1 for m in kv._manifest.segments if m.level == bottom) >= 2

    kv.delete(_k(2))
    kv.delete(_k(5))
    for i in range(8, 12):
        kv.put(_k(i), f"v{i}".encode())
    kv.commit_epoch(2)                       # spill 1
    for i in range(12, 16):
        kv.put(_k(i), f"v{i}".encode())
    kv.commit_epoch(3)                       # spill 2 → L0 merge above bottom
    want = {_k(i): f"v{i}".encode() for i in range(16) if i not in (2, 5)}
    assert dict(kv.scan(b"k")) == want
    assert kv.get(_k(2)) is None and kv.get(_k(5)) is None
    assert kv.get(_k(3)) == b"v3"
    # the tombstones were NOT dropped: the bottom level still holds the
    # old versions, so some shallower segment must carry them
    live_tombs = sum(1 for _, seg in kv._read_order
                     for _, v in seg.iter_all() if v is TOMBSTONE)
    assert live_tombs == 2, "tombstone dropped while a deeper level remained"

    kv.compact()                             # no deeper level ⇒ drop
    assert dict(kv.scan(b"k")) == want
    assert kv.get(_k(2)) is None
    assert sum(1 for _, seg in kv._read_order
               for _, v in seg.iter_all() if v is TOMBSTONE) == 0
    kv.close()


@settings(max_examples=12, deadline=None)
@given(st.integers(min_value=0, max_value=10 ** 6))
def test_get_equals_scan_then_filter(tmp_path_factory, seed):
    """Property: for every key ever touched, point
    ``get`` agrees with a full ``scan`` materialized then filtered — the
    binary-searched path and the k-way-merge path are the same view."""
    import random
    rng = random.Random(seed)
    d = str(tmp_path_factory.mktemp("prop") / "kv")
    kv = DurableKV(d, memtable_limit=4, sync="none", level_ratio=2,
                   segment_target_bytes=32)
    pool = [_k(i) for i in range(24)]
    epoch = 0
    for _ in range(rng.randint(3, 8)):
        for _ in range(rng.randint(1, 6)):
            k = rng.choice(pool)
            if rng.random() < 0.25:
                kv.delete(k)
            else:
                kv.put(k, f"s{seed}-{rng.randint(0, 99)}".encode())
        epoch += 1
        kv.commit_epoch(epoch)
        if rng.random() < 0.2:
            kv.compact()
    full = dict(kv.scan(b""))
    for k in pool:
        assert kv.get(k) == full.get(k)
    kv.close()


# ---------------------------------------------------------------------------
# compaction backpressure
# ---------------------------------------------------------------------------
def _burst(kv, waves, per_wave=8):
    """Drive ``waves`` write waves; → per-wave merged-bytes trace."""
    trace, n, epoch = [], 0, 0
    for _ in range(waves):
        for _ in range(per_wave):
            kv.put(_k(n), b"x" * 16)
            n += 1
        epoch += 1
        kv.commit_epoch(epoch)
        trace.append(kv.last_compact_bytes)
    return trace, epoch


def test_compact_budget_bounds_per_wave_merge_work(tmp_path):
    """Compaction-burst serving: with a budget set,
    the merge work charged to ANY wave boundary is bounded (p99 == max
    here — the trace is exact), debt accrues during the burst and drains
    after it; the identical unbudgeted workload pays for whole cascades
    inside single waves."""
    budget = 400
    kv = DurableKV(str(tmp_path / "budgeted"), memtable_limit=8,
                   sync="none", level_ratio=2, segment_target_bytes=64,
                   compact_budget_bytes=budget)
    trace, epoch = _burst(kv, waves=24)
    # bound: the budget plus at most one partition's overshoot
    slack = 300
    assert max(trace) <= budget + slack, trace
    assert kv.compact_debt() > 0, "a throttled burst should owe work"
    drain = 0
    while kv.compact_debt() > 0:             # idle waves pay the debt off
        epoch += 1
        kv.commit_epoch(epoch)
        assert kv.last_compact_bytes <= budget + slack
        drain += 1
        assert drain < 200, "debt never drained"
    assert dict(kv.scan(b"k")) == {_k(i): b"x" * 16 for i in range(24 * 8)}
    kv.close()

    kv2 = DurableKV(str(tmp_path / "unbounded"), memtable_limit=8,
                    sync="none", level_ratio=2, segment_target_bytes=64,
                    compact_budget_bytes=0)
    trace2, _ = _burst(kv2, waves=24)
    assert kv2.compact_debt() == 0           # unbounded never defers
    assert max(trace2) > budget + slack, \
        "the unbudgeted burst never stalled a wave — workload too small " \
        f"to prove throttling matters (max {max(trace2)})"
    assert dict(kv2.scan(b"k")) == {_k(i): b"x" * 16 for i in range(24 * 8)}
    kv2.close()


# ---------------------------------------------------------------------------
# stats plumbing: DurableKV → PathStore → HostEngine → obs snapshot
# ---------------------------------------------------------------------------
def test_seg_probe_and_compact_debt_reach_engine_stats(tmp_path):
    """``d_seg_probe`` (delta-synced counter) and ``d_compact_debt``
    (gauge) surface through ``QueryEngine.stats`` and nest under the
    snapshot's ``durable`` section, for both shard shapes."""
    for shards in (1, 2):
        root = str(tmp_path / f"s{shards}")
        store = open_durable_store(root, n_shards=shards, sync="none",
                                   memtable_limit=8,
                                   segment_target_bytes=64,
                                   compact_budget_bytes=512)
        eng = HostEngine(store)
        eng.writer.ensure_root("root")
        eng.admit_many([("/d", R.DirRecord(name="d", summary="dim"))])
        paths = [f"/d/e{i}" for i in range(24)]
        for lo in range(0, 24, 8):           # one wave per batch of 8
            eng.admit_many([
                (p, R.FileRecord(name=p.rsplit("/", 1)[1], text=f"body {p}"))
                for p in paths[lo:lo + 8]])
            eng.refresh(force=True)          # wave boundary: spill + merge
        eng.q1_get(paths)                    # cold-ish point reads
        eng.sync_durable_stats()
        assert eng.stats.ops.get(D_SEG_PROBE, 0) > 0
        assert D_COMPACT_DEBT in eng.stats.ops
        debt = eng.stats.ops[D_COMPACT_DEBT]
        assert debt == (store.compact_debt() or 0) >= 0
        snap = obs.build_snapshot(engine=eng)
        assert snap["durable"]["seg_probe"] == eng.stats.ops[D_SEG_PROBE]
        assert snap["durable"]["compact_debt"] == eng.stats.ops[D_COMPACT_DEBT]
        assert snap["durable"]["backpressure"] == bool(debt)
        store.close()


def test_volatile_store_reports_no_compact_debt():
    """A MemKV-backed engine must not grow a phantom debt gauge."""
    from repro_torch.core.store import PathStore
    eng = HostEngine(PathStore(MemKV()))
    eng.writer.ensure_root("root")
    eng.sync_durable_stats()
    assert D_COMPACT_DEBT not in eng.stats.ops
    snap = obs.build_snapshot(engine=eng)
    assert snap["durable"]["compact_debt"] == 0
    assert snap["durable"]["backpressure"] is False

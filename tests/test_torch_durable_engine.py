"""The port's engines over its durable tier (``repro_torch.storage``): the
reference's durable-engine tests (a crash loses at most the uncommitted
wave; a DeviceEngine on ``device="cpu"`` rehydrates epoch-consistently
from the WAL's invalidation journal; the durable read counters surface
through ``HostEngine.stats``), and one seeded crash-and-reopen run
through both packages' engines with equal epochs, rehydrated paths and
Q1–Q4 answers.

The randomized-wiki helpers are the reference engine suite's, over the
port; ``test_torch_concurrency.py`` imports them from here.  This module
imports JAX only inside the cross-package test."""
import random

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import paths as P  # noqa: E402
from repro_torch.core import records as R  # noqa: E402
from repro_torch.core.consistency import WikiWriter  # noqa: E402
from repro_torch.core.engine import (BatchPlanner, DeviceEngine, HostEngine,  # noqa: E402
                                     ShardedPathStore)


# ---------------------------------------------------------------------------
# randomized wiki construction through the write protocol
# ---------------------------------------------------------------------------
def _random_wiki(store, seed: int) -> dict:
    """Admit a random tree (protocol-respecting), leave some orphans via
    partial admissions, unlink some nodes.  Returns query material."""
    rng = random.Random(seed)
    w = WikiWriter(store, clock=lambda: 0.0)  # deterministic meta timestamps
    w.ensure_root("root")
    dims = [f"d{i}" for i in range(rng.randint(2, 4))]
    live, orphans = [], []
    for d in dims:
        w.admit(f"/{d}", R.DirRecord(name=d, summary=f"dim {d}"))
        for e in range(rng.randint(1, 5)):
            path = f"/{d}/ent_{e}_{rng.randint(0, 9)}"
            as_dir = rng.random() < 0.3
            rec = (R.DirRecord(name=P.basename(path), summary=f"sub of {d}")
                   if as_dir else
                   R.FileRecord(name=P.basename(path),
                                text=f"text {d} {e} {rng.random():.3f}"))
            if rng.random() < 0.15:
                # orphan: child written, parent update never happens
                steps = w.admit_steps(path, rec)
                next(steps)
                orphans.append(path)
            else:
                w.admit(path, rec)
                live.append(path)
                if as_dir:
                    sub = path + f"/sub{rng.randint(0, 3)}"
                    w.admit(sub, R.FileRecord(name=P.basename(sub),
                                              text=f"sub {sub}"))
                    live.append(sub)
    # a few deletions (reverse-order unlink keeps the store consistent)
    for path in rng.sample(live, min(2, len(live))):
        w.unlink(path)
        live.remove(path)
    missing = [f"/{d}/nope_{i}" for i, d in enumerate(dims)] + ["/zz/yy"]
    return {"rng": rng, "dims": dims, "live": live, "orphans": orphans,
            "missing": missing}


def _query_batches(mat):
    rng = mat["rng"]
    pool = mat["live"] + mat["orphans"] + mat["missing"] + ["/"]
    q1 = [rng.choice(pool) for _ in range(24)]
    q2 = ["/"] + [P.SEP + d for d in mat["dims"]] + q1[:8]
    q3 = [rng.choice(pool) for _ in range(8)]
    prefixes = ["/", P.SEP + mat["dims"][0], "/zz",
                rng.choice(pool), mat["dims"][-1]]  # last: no leading slash
    tokens = ["ent", "sub", "nothere", mat["dims"][0],
              P.basename(rng.choice(mat["live"] or ["/x"]))]
    return q1, q2, q3, prefixes, tokens


# ---------------------------------------------------------------------------
# durable tier under the engines — epoch-consistent restart
# ---------------------------------------------------------------------------
def test_durable_restart_loses_at_most_uncommitted_wave(tmp_path):
    """Recovery after a simulated mid-wave crash loses at most the
    uncommitted wave — the Δ = 1-wave staleness invariant holds across
    restart.  Committed waves are exact; the engine resumes the
    committed epoch sequence."""
    from repro_torch.storage import open_durable_store
    root = str(tmp_path / "wiki")
    store = open_durable_store(root, n_shards=2, sync="none")
    host = HostEngine(store)
    pl = BatchPlanner(host)
    committed: dict[str, str] = {}
    pl.admit("/d0", R.DirRecord(name="d0"))
    for wave in range(3):
        for i in range(2):
            path = f"/d0/w{wave}_{i}"
            pl.admit(path, R.FileRecord(name=P.basename(path),
                                        text=f"{wave}:{i}"))
            committed[path] = f"{wave}:{i}"
        pl.flush()
        host.refresh()                     # wave boundary = WAL commit
    committed_epoch = host.epoch
    # mid-wave crash: writes executed (live view sees them) but refresh —
    # the group commit — never runs
    pl.admit("/d0/lost", R.FileRecord(name="lost", text="x"))
    pl.flush()
    assert store.get("/d0/lost") is not None
    del pl, host, store                    # crash: no close(), no commit

    reopened = open_durable_store(root, sync="none")
    host2 = HostEngine(reopened)
    assert host2.epoch == committed_epoch  # epoch rehydrated, not reset
    assert reopened.get("/d0/lost") is None
    for path, text in committed.items():
        assert reopened.get(path).text == text
    # the next wave continues the epoch sequence exactly one ahead
    pl2 = BatchPlanner(host2)
    pl2.admit("/d0/after", R.FileRecord(name="after", text="y"))
    pl2.flush()
    assert host2.refresh() == committed_epoch + 1
    reopened.close()


def rehydration_scenario(tmp_path, device):
    """The reference's rehydration test with the DeviceEngine on
    ``device`` (the card tests run it with "cuda")."""
    from repro_torch.storage import open_durable_store
    root = str(tmp_path / "wiki")
    store = open_durable_store(root, sync="none")
    store.put_record("/", R.DirRecord(name=""))
    store.flush()
    # the real mirror topology: the device engine attaches the WAL
    # journal (only a device consumer may — its DEVMARKs clear it); the
    # host engine shares its writer/bus and commits write waves, but the
    # device mirror never refreshes before the crash
    dev = DeviceEngine.from_store(store, device=device)
    host = HostEngine(store, writer=dev.writer)
    pl = BatchPlanner(host)
    pl.admit("/d0", R.DirRecord(name="d0"))
    pl.admit("/d0/e0", R.FileRecord(name="e0", text="v0"))
    pl.flush()
    host.refresh()
    assert store.pending_invalidations()   # journaled, not device-applied
    del pl, host, dev, store               # crash

    reopened = open_durable_store(root, sync="none")
    pending_before = set(reopened.pending_invalidations())
    assert {"/d0", "/d0/e0"} <= pending_before
    dev = DeviceEngine.from_store(reopened, device=device)
    assert dev.epoch == 1
    assert set(dev.rehydrated_paths) == pending_before
    # the fresh freeze subsumed the pending deltas: journal now applied
    assert reopened.pending_invalidations() == []
    host2 = HostEngine(reopened)
    probe = reopened.all_paths() + ["/d0/ghost"]
    assert dev.q1_get(probe) == host2.q1_get(probe)
    assert dev.q4_search(["/", "/d0"]) == host2.q4_search(["/", "/d0"])
    # Δ = 1 wave still holds post-restart: same-wave writes invisible,
    # visible after exactly one refresh, and the DEVMARK makes the next
    # reopen rehydrate nothing
    pl2 = BatchPlanner(dev)
    pl2.admit("/d0/e1", R.FileRecord(name="e1", text="v1"))
    f_read = pl2.get("/d0/e1")
    pl2.flush()
    assert f_read.value is None
    assert dev.refresh() == 2
    assert dev.q1_get(["/d0/e1"])[0].text == "v1"
    reopened.close()
    again = open_durable_store(root, sync="none")
    dev2 = DeviceEngine.from_store(again, device=device)
    assert dev2.epoch == 2 and dev2.rehydrated_paths == []
    assert dev2.q1_get(["/d0/e1"])[0].text == "v1"
    again.close()


def test_durable_device_rehydration_epoch_consistent(tmp_path):
    """DeviceEngine over a reopened durable store: the committed-but-
    never-device-applied dirty paths journaled in the WAL surface as the
    rehydration work list, the restored epoch matches the store's last
    commit, and the rehydrated engine answers every Q1–Q4 batch
    identically to the host over the same reopened state."""
    rehydration_scenario(tmp_path, "cpu")


def test_host_engine_surfaces_durable_read_counters(tmp_path):
    """Bloom-negative and block-cache counters from the durable tier
    surface through ``QueryEngine.stats`` (delta'd — refresh after
    refresh never double-counts), and stay absent over volatile stores."""
    from repro_torch.core.engine import D_BLOOM_NEG, D_CACHE_HIT, D_CACHE_MISS
    from repro_torch.storage import open_durable_store

    root = str(tmp_path / "wiki")
    store = open_durable_store(root, n_shards=2, sync="none",
                               memtable_limit=8, level_ratio=100)
    eng = HostEngine(store)
    for i in range(48):
        # varied names: FNV digests of near-identical short paths skew,
        # and both shards must end up holding segments
        eng.admit_many([(f"/d{i % 4}/ent_{i * 37}",
                         R.FileRecord(name=f"ent_{i * 37}",
                                      text=f"body {i}"))])
        if i % 8 == 7:
            eng.refresh(force=True)       # wave commit → spill
    eng.refresh(force=True)
    assert all(sh.engine.level_counts() for sh in store.shards), \
        "setup: every shard must hold at least one segment"

    misses = [f"/d{i % 4}/absent_{i * 53}" for i in range(16)]
    assert eng.q1_get(misses) == [None] * 16
    eng.sync_durable_stats()
    negs = eng.stats.ops.get(D_BLOOM_NEG, 0)
    assert negs > 0, "miss probes produced no bloom negatives"
    eng.sync_durable_stats()              # idempotent: no new reads
    assert eng.stats.ops.get(D_BLOOM_NEG, 0) == negs

    hit = eng.q1_get(["/d3/ent_111"])[0]  # repeated hits warm the cache
    assert hit is not None and eng.q1_get(["/d3/ent_111"])[0] is not None
    eng.sync_durable_stats()
    assert eng.stats.ops.get(D_CACHE_HIT, 0) + \
        eng.stats.ops.get(D_CACHE_MISS, 0) > 0
    store.close()

    mem_eng = HostEngine(ShardedPathStore(n_shards=2))
    mem_eng.q1_get(["/nope"])
    mem_eng.sync_durable_stats()
    assert D_BLOOM_NEG not in mem_eng.stats.ops
    assert D_CACHE_HIT not in mem_eng.stats.ops


# ---------------------------------------------------------------------------
# the same crash and reopen through both packages
# ---------------------------------------------------------------------------
def _crash_and_reopen(pkg, root: str, seed: int, dev_kw: dict) -> dict:
    """Build a seeded wiki in a 2-shard durable store through ``pkg``'s
    writer, mirror it in a DeviceEngine, commit wave A through a
    HostEngine sharing the device writer (the device never refreshes),
    flush wave B uncommitted, crash, reopen and rehydrate.  Returns what
    the reopened tier shows, records as their encoded bytes."""
    from test_torch_engine import _answers, _grow, _queries, canon
    store = pkg.open_durable_store(root, n_shards=2, sync="none")
    dims, live = _grow(pkg.WikiWriter(store, clock=lambda: 0.0), pkg.R, seed)
    store.flush()
    dev = pkg.DeviceEngine.from_store(
        store, writer=pkg.WikiWriter(store, clock=lambda: 1.0), **dev_kw)
    host = pkg.HostEngine(store, writer=dev.writer)
    pl = pkg.BatchPlanner(host)
    wave_a = [f"/{dims[0]}/wave_a{i}" for i in range(3)] + ["/newdim", "/newdim/leaf"]
    for p in wave_a:
        rec = (pkg.R.DirRecord(name="newdim", summary="added") if p == "/newdim"
               else pkg.R.FileRecord(name=p.rsplit("/", 1)[1], text=f"a {p}"))
        pl.admit(p, rec)
    if live:
        pl.unlink(live[-1])
    pl.flush()
    host.refresh()                          # wave A: committed
    wave_b = [f"/{dims[-1]}/wave_b{i}" for i in range(2)]
    for p in wave_b:
        pl.admit(p, pkg.R.FileRecord(name=p.rsplit("/", 1)[1], text=f"b {p}"))
    pl.flush()                              # wave B: never committed
    del pl, host, dev, store                # crash

    reopened = pkg.open_durable_store(root, sync="none")
    pending = reopened.pending_invalidations()
    dev2 = pkg.DeviceEngine.from_store(reopened, **dev_kw)
    qs = _queries(dims, live + wave_a + wave_b, seed)
    out = {"epoch": dev2.epoch, "last_epoch": reopened.last_epoch(),
           "pending": sorted(pending), "rehydrated": sorted(dev2.rehydrated_paths),
           "pending_after": reopened.pending_invalidations(),
           "wave_b": canon(dev2.q1_get(wave_b)), "answers": _answers(dev2, qs),
           "host": _answers(pkg.HostEngine(reopened), qs)}
    reopened.close()
    return out


@pytest.mark.parametrize("seed", [2, 9])
def test_crash_and_reopen_matches_the_reference(tmp_path, seed):
    import types

    from repro.core import records as JR
    from repro.core.consistency import WikiWriter as JWriter
    from repro.core.engine import BatchPlanner as JPlanner
    from repro.core.engine import DeviceEngine as JDevice
    from repro.core.engine import HostEngine as JHost
    from repro.storage import open_durable_store as jopen
    from repro_torch.storage import open_durable_store

    ref = types.SimpleNamespace(open_durable_store=jopen, WikiWriter=JWriter, R=JR,
                                DeviceEngine=JDevice, HostEngine=JHost, BatchPlanner=JPlanner)
    port = types.SimpleNamespace(open_durable_store=open_durable_store, WikiWriter=WikiWriter,
                                 R=R, DeviceEngine=DeviceEngine, HostEngine=HostEngine,
                                 BatchPlanner=BatchPlanner)
    want = _crash_and_reopen(ref, str(tmp_path / "ref"), seed, {})
    got = _crash_and_reopen(port, str(tmp_path / "port"), seed, {"device": "cpu"})
    assert got == want
    assert got["epoch"] == got["last_epoch"] == 1
    assert got["pending"] and got["rehydrated"] == got["pending"]
    assert got["pending_after"] == [] and got["wave_b"] == [None, None]
    assert got["answers"] == got["host"]

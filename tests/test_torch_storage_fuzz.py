"""The reference's crash-injection fuzz harness over the port's storage
tier (``repro_torch.storage``).

Every case is a SEEDED, fully deterministic two-pass experiment:

1. **Counting pass** — run a randomized put/delete/commit/spill/compact/
   reopen workload against a real ``DurableKV`` with a pure-counting
   failpoint plan armed, learning how many faultable IO operations
   (WAL appends/commits/fsyncs, segment writes, manifest writes/swaps)
   the schedule performs.
2. **Crash pass** — rerun the *identical* workload from scratch with a
   crash injected at a seed-chosen operation index, either failing the
   IO cleanly or tearing the write (a prefix reaches the disk).  The
   wounded store is abandoned mid-flight, reopened, and must recover to
   **byte equality** with an in-memory oracle that replayed only the
   outcomes a crash permits: the state as of the last durable commit,
   or that plus the in-flight wave (the crash may land after the wave's
   group commit but during spill/merge).  The store then keeps serving:
   a post-recovery wave must commit and read back exactly.

The workload's geometry (tiny segment target, ratio 2, sometimes a
merge budget) makes partitioned multi-segment merges and budget-paused
resumable merges common, so crash points land inside them.

``test_storage_fuzz_seeded`` (tier-1) samples a small number of seeds
via the (possibly vendored) hypothesis ``@given``.  The extended sweep
``test_storage_fuzz_extended`` is opt-in — set ``REPRO_FUZZ_CASES``
(the CI storage-fuzz leg uses 200); it prints the failing seed so any
crash schedule reproduces from the command line.
"""
import os
import random
import shutil
import tempfile

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.storage import DurableKV
from repro_torch.storage import failpoints as FPS
from repro_torch.storage import manifest as MF

_POOL = [f"k{i:04d}".encode() for i in range(16)]
_OPS = ("put", "put", "put", "delete", "commit", "commit", "spill",
        "compact", "reopen")


def _apply(base: dict, wave: list) -> dict:
    out = dict(base)
    for op in wave:
        if op[0] == "put":
            out[op[1]] = op[2]
        else:
            out.pop(op[1], None)
    return out


class _Oracle:
    """Durable state (``base``) + the open wave's ops (``wave``)."""

    def __init__(self):
        self.base: dict = {}
        self.wave: list = []

    def committed(self):
        """The wave became durable: fold it in."""
        self.base = _apply(self.base, self.wave)
        self.wave = []

    def allowed(self) -> tuple[dict, dict]:
        """The two states a crash can legally recover to."""
        return self.base, _apply(self.base, self.wave)


def _open(d: str, budget: int, sync: str = "none") -> DurableKV:
    return DurableKV(d, memtable_limit=4, sync=sync, level_ratio=2,
                     segment_target_bytes=48, compact_budget_bytes=budget)


class _Workload:
    """One seeded op schedule, replayed identically in both passes."""

    def __init__(self, d: str, seed: int, n_ops: int = 40):
        self.d = d
        self.rng = random.Random(seed)
        self.budget = self.rng.choice([0, 0, 150])
        # mostly sync="none" for speed; some seeds fsync so the
        # *.fsync failpoint sites land in the crash-schedule space too
        self.sync = self.rng.choice(["none", "none", "none", "fsync"])
        self.n_ops = n_ops
        self.oracle = _Oracle()
        self.epoch = 0
        self.kv = _open(d, self.budget, self.sync)

    def run(self) -> None:
        for _ in range(self.n_ops):
            self.step()

    def step(self) -> None:
        op = self.rng.choice(_OPS)
        if op == "put":
            k = self.rng.choice(_POOL)
            v = f"v{self.rng.randint(0, 999)}".encode()
            self.kv.put(k, v)
            self.oracle.wave.append(("put", k, v))
        elif op == "delete":
            k = self.rng.choice(_POOL)
            self.kv.delete(k)
            self.oracle.wave.append(("del", k))
        elif op == "commit":
            self.epoch += 1
            self.kv.commit_epoch(self.epoch)
            self.oracle.committed()
        elif op == "spill":
            self.kv.spill()
            self.oracle.committed()
        elif op == "compact":
            self.kv.compact()
            self.oracle.committed()
        else:                                # reopen (clean close commits)
            self.kv.close()
            self.oracle.committed()
            self.kv = _open(self.d, self.budget, self.sync)

    def abandon(self) -> None:
        """Release handles like a dead process (no commit).  The
        background compaction worker is stopped first — a dead process
        has no threads, and a live one would keep mutating the store
        we are about to declare dead."""
        self.kv._stop_bg()
        try:
            self.kv._wal._f.close()
        except Exception:
            pass
        for t in getattr(self.kv, "_tables", {}).values():
            try:
                t.close()
            except Exception:
                pass


def _check_invariants(kv: DurableKV, d: str, seed: int) -> None:
    """No orphans, no unpaid-for files, partitioned-level sanity.

    Runs under ``kv._lock``: the background compaction worker mutates
    the manifest, the levels, and the segment files atomically w.r.t.
    that lock, so a locked read always sees a consistent cut."""
    with kv._lock:
        live = set(kv._manifest.segment_names())
        if kv._manifest.compaction is not None:
            live.update(o.name for o in kv._manifest.compaction.outputs)
        on_disk = {n for n in os.listdir(d) if n.endswith(".seg")}
        assert on_disk == live, f"seed {seed}: disk/manifest drift"
        for view in kv._levels:
            if view.partitioned:
                for a, b in zip(view.entries, view.entries[1:]):
                    assert bytes.fromhex(b[0].min_key) > \
                        bytes.fromhex(a[0].max_key), \
                        f"seed {seed}: level {view.level} ranges overlap"


def _fuzz_one(root: str, seed: int) -> None:
    """One full counting-pass + crash-pass experiment under ``root``."""
    # pass 1: count the schedule's faultable IO ops
    d1 = os.path.join(root, "count")
    wl = _Workload(d1, seed)
    with FPS.armed(FPS.FailPlan(crash_at=0)) as counter:
        wl.run()
    wl.kv.close()
    # the completed run must equal its oracle exactly (no crash at all)
    reopened = _open(d1, wl.budget, wl.sync)
    assert dict(reopened.scan(b"")) == _apply(wl.oracle.base,
                                              wl.oracle.wave), \
        f"seed {seed}: crash-free run diverged from oracle"
    reopened.close()
    n_ops = len(counter.hits)
    if n_ops == 0:
        return                               # schedule did no durable IO

    # pass 2: same schedule, crash injected at a seed-chosen boundary
    pick = random.Random(seed ^ 0x5EEDFA11)
    crash_at = pick.randint(1, n_ops)
    mode = pick.choice(["fail", "torn"])
    d2 = os.path.join(root, "crash")
    wl2 = _Workload(d2, seed)
    crashed = False
    try:
        with FPS.armed(FPS.FailPlan(crash_at=crash_at, mode=mode)):
            wl2.run()
    except FPS.InjectedCrash:
        crashed = True
    wl2.abandon()
    # recover and hold the oracle to byte equality
    kv = _open(d2, wl2.budget, wl2.sync)
    got = dict(kv.scan(b""))
    if crashed:
        lo, hi = wl2.oracle.allowed()
        assert got in (lo, hi), \
            (f"seed {seed} crash_at={crash_at} mode={mode}: recovered "
             f"state matches neither committed nor committed+wave")
    else:
        # the crash point landed past the schedule's end (counting pass
        # included close/reopen IO the shorter path skipped) — the run
        # completed; it must equal the full oracle
        assert got == _apply(wl2.oracle.base, wl2.oracle.wave), \
            f"seed {seed}: uncrashed pass-2 run diverged"
    _check_invariants(kv, d2, seed)
    # the recovered store keeps working: one more wave, exact readback
    base = dict(got)
    for i, k in enumerate(_POOL[:4]):
        kv.put(k, f"post{i}".encode())
        base[k] = f"post{i}".encode()
    kv.commit_epoch(100)
    while kv.compact_debt() > 0:             # drain any paused merge
        kv.commit_epoch(kv.last_epoch() + 1)
    assert dict(kv.scan(b"")) == base, f"seed {seed}: post-crash wave lost"
    _check_invariants(kv, d2, seed)
    kv.close()


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_storage_fuzz_seeded(tmp_path_factory, seed):
    """Tier-1 sample of the crash-schedule space (see module docstring)."""
    _fuzz_one(str(tmp_path_factory.mktemp("fuzz")), seed)


@pytest.mark.slow
def test_storage_fuzz_extended():
    """Opt-in sweep: ``REPRO_FUZZ_CASES=200`` in the CI storage-fuzz leg.
    Prints the failing seed — rerun it via ``_fuzz_one`` or by setting
    ``REPRO_FUZZ_SEED`` to pin the sweep to that one case."""
    n = int(os.environ.get("REPRO_FUZZ_CASES", "0") or "0")
    if n <= 0:
        pytest.skip("set REPRO_FUZZ_CASES=<n> to run the extended sweep")
    pinned = os.environ.get("REPRO_FUZZ_SEED")
    seeds = ([int(pinned)] if pinned else
             [(case * 2654435761 + 97) % 2 ** 32 for case in range(n)])
    for case, seed in enumerate(seeds):
        root = tempfile.mkdtemp(prefix="repro_fuzz_")
        try:
            _fuzz_one(root, seed)
        except BaseException:
            print(f"\nFUZZ FAILURE: case {case} seed={seed} — reproduce "
                  f"with REPRO_FUZZ_CASES=1 REPRO_FUZZ_SEED={seed}")
            raise
        finally:
            shutil.rmtree(root, ignore_errors=True)

"""Deterministic failpoint injection for crash-testing the durable tier.

The WAL, SSTable writer, and manifest route their durability-critical
IO through this module.  When no plan is armed (the default) every hook
is a cheap no-op, so production code pays one ``is None`` check per
faultable operation.  When a :class:`FailPlan` is armed, the N-th
operation whose site matches the plan raises :class:`InjectedCrash` —
either *before* any bytes reach the file (``mode="fail"``) or after a
torn prefix has been written and flushed (``mode="torn"``), simulating
a power cut mid-write.

Two arming paths:

* in-process tests use the :func:`armed` context manager;
* subprocess crash tests set ``REPRO_FAILPOINT="N[:mode[:site,site]]"``
  in the child environment — the plan is armed at import time, so the
  child dies with a nonzero exit the moment the N-th matching op runs.

Sites currently wired (see wal.py / sstable.py / manifest.py):

    ==================  =====================================================
    site                faultable operation
    ==================  =====================================================
    wal.append          a record is staged into the group-commit buffer
    wal.commit          the buffered wave (incl. COMMIT frame) hits the file
    wal.fsync           the WAL file fsync after a group commit
    segment.write       an SSTable body is written (single large write)
    segment.fsync       the segment-file fsync after the body write
    manifest.write      the manifest JSON is written to its tmp file
    manifest.fsync      the tmp-file fsync before the atomic rename
    manifest.replace    the atomic ``os.replace`` that publishes the manifest
    ==================  =====================================================

Counting is global across sites unless the plan restricts ``sites``:
the plan's counter increments once per *matching* faultable op, and the
op whose count equals ``crash_at`` dies.  ``crash_at <= 0`` never
fires, which turns the plan into a pure op counter (``plan.hits``) —
the fuzz harness uses that to learn a schedule's length before picking
a crash point.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

ENV = "REPRO_FAILPOINT"

SITES = (
    "wal.append", "wal.commit", "wal.fsync",
    "segment.write", "segment.fsync",
    "manifest.write", "manifest.fsync", "manifest.replace",
)


class InjectedCrash(RuntimeError):
    """Raised by an armed failpoint; simulates the process dying here."""

    def __init__(self, site: str, op_index: int):
        super().__init__(f"injected crash at {site} (op #{op_index})")
        self.site = site
        self.op_index = op_index


@dataclass
class FailPlan:
    """One deterministic crash schedule.

    ``crash_at`` is 1-based over matching ops; ``mode`` is ``"fail"``
    (die before any bytes are written) or ``"torn"`` (write
    ``int(len * torn_keep)`` bytes, capped at ``len - 1`` so the write
    is never accidentally complete, flush, then die).  ``sites=None``
    matches every site.
    """

    crash_at: int
    mode: str = "fail"
    sites: frozenset[str] | None = None
    torn_keep: float = 0.5
    seen: int = 0
    fired: bool = False
    hits: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.mode not in ("fail", "torn"):
            raise ValueError(f"unknown failpoint mode: {self.mode!r}")
        unknown = set(self.sites or ()) - set(SITES)
        if unknown:
            raise ValueError(f"unknown failpoint sites: {sorted(unknown)}")

    def _matches(self, site: str) -> bool:
        return self.sites is None or site in self.sites


_ACTIVE: FailPlan | None = None

# Faultable ops may run on worker threads (shard executor, commit
# sequencer, background compaction) with one plan armed process-wide:
# the counter mutation must be atomic or two concurrent ops could both
# claim the crash_at slot (double fire) or skip it entirely.
_PLAN_LOCK = threading.Lock()


def arm(plan: FailPlan) -> None:
    global _ACTIVE
    _ACTIVE = plan


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> FailPlan | None:
    return _ACTIVE


class armed:
    """``with failpoints.armed(plan): ...`` — arms for the block only."""

    def __init__(self, plan: FailPlan):
        self.plan = plan

    def __enter__(self) -> FailPlan:
        arm(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        disarm()


def _tick(plan: FailPlan, site: str) -> tuple[bool, int]:
    """Atomically count one matching op; → (should_crash, op_index)."""
    with _PLAN_LOCK:
        if plan.fired or not plan._matches(site):
            return False, 0
        plan.seen += 1
        plan.hits.append(site)
        if plan.seen == plan.crash_at:
            plan.fired = True
            return True, plan.seen
        return False, plan.seen


def hit(site: str) -> None:
    """A faultable op with no payload (fsync, rename): maybe die here."""
    plan = _ACTIVE
    if plan is None:
        return
    crash, idx = _tick(plan, site)
    if crash:
        raise InjectedCrash(site, idx)


def write(site: str, f, data: bytes) -> None:
    """A faultable write: either completes, dies clean, or dies torn.

    In torn mode the prefix is flushed before raising so the partial
    bytes are durable from the recovering process's point of view —
    the worst case a real power cut can leave behind.
    """
    plan = _ACTIVE
    if plan is None:
        f.write(data)
        return
    crash, idx = _tick(plan, site)
    if not crash:
        f.write(data)
        return
    if plan.mode == "torn" and data:
        keep = min(len(data) - 1, max(0, int(len(data) * plan.torn_keep)))
        f.write(data[:keep])
        f.flush()
    raise InjectedCrash(site, idx)


def plan_from_env(env: str | None = None) -> FailPlan | None:
    """Parse ``REPRO_FAILPOINT="N[:mode[:site,site]]"`` into a plan."""
    raw = os.environ.get(ENV) if env is None else env
    if not raw:
        return None
    parts = raw.split(":")
    crash_at = int(parts[0])
    mode = parts[1] if len(parts) > 1 and parts[1] else "fail"
    sites = None
    if len(parts) > 2 and parts[2]:
        sites = frozenset(s.strip() for s in parts[2].split(",") if s.strip())
    return FailPlan(crash_at=crash_at, mode=mode, sites=sites)


_env_plan = plan_from_env()
if _env_plan is not None:       # pragma: no cover - subprocess-only path
    arm(_env_plan)

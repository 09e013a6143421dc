"""Segment registry: the single source of truth for which segment files
are live — and, since the leveled-compaction PR, *where* each one sits in
the level hierarchy.  Written atomically (write-new-then-rename — the
same pattern as ``checkpoint/manager.py``'s step commit).

The manifest carries everything recovery needs besides the WAL itself:

* ``segments``      — live :class:`SegmentMeta` entries in chronological
                      (creation) order.  Within a level, later entries
                      shadow earlier ones; across levels, a lower level
                      always shadows a higher one (data only ever moves
                      downward, so every version in level L is newer than
                      any version of the same key below it).  Levels ≥ 1
                      written by partitioned compaction are key-range
                      disjoint, so shadowing within them never arises.
* ``next_seg``      — monotone id allocator (never reused within a
                      manifest lineage, so a crashed spill's or merge's
                      orphan file can never collide with a live one)
* ``epoch``         — last committed write epoch at manifest-write time
* ``device_epoch``  — epoch the device tier had applied when last marked
* ``pending_inval`` — journaled invalidation paths committed after
                      ``device_epoch`` (survives WAL truncation at spill
                      so device rehydration stays exact)
* ``compaction``    — in-flight resumable merge state (format 3), or
                      null when no merge is paused.  Inputs remain live
                      in ``segments`` for readers; ``outputs`` are
                      durable partition files not yet published.  A
                      budget-paused merge persists this state so a crash
                      resumes from ``next_key`` instead of redoing (or
                      worse, leaking) completed partitions.

Schema versions: format 3 (current) adds the ``compaction`` field;
format 2 stored ``segments`` as objects with ``level`` and the
bloom/key-range summary; format 1 (PR 3) stored bare file names.
``load`` accepts all three — a PR-3 manifest opens with every segment at
level 0 and unknown stats, a format-2 manifest opens with no pending
merge, and the first manifest write migrates either to format 3 on
disk.  Round-trip compatibility is tested in tests/test_storage.py.

A crash between segment write and manifest swap leaves an unreferenced
``seg_*.seg`` file; ``load`` reports live names so the engine can sweep
orphans.  Files named by ``compaction.outputs`` are *not* orphans —
they are paid-for merge work a resume will publish.  A crash mid-rename
is impossible to observe: ``os.replace`` is atomic on POSIX.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

from . import failpoints as FP

MANIFEST_NAME = "MANIFEST.json"

#: current manifest schema version
#: (1 = PR-3 flat names, 2 = leveled, 3 = + resumable compaction state)
FORMAT = 3


@dataclass
class SegmentMeta:
    """One live segment's manifest entry.

    ``min_key``/``max_key`` are hex-encoded (JSON-safe) first/last keys;
    empty string means unknown (a migrated PR-3 segment).  ``bloom_k`` /
    ``bloom_bits`` summarize the filter serialized in the segment footer
    (0/0 → the segment carries none and every probe must touch it)."""

    name: str
    level: int = 0
    records: int = 0
    bytes: int = 0
    min_key: str = ""
    max_key: str = ""
    bloom_k: int = 0
    bloom_bits: int = 0


@dataclass
class CompactionState:
    """A paused (budget-throttled) merge, recorded crash-safely.

    ``inputs`` are segment names still live in ``segments``; ``outputs``
    are completed, fsynced partition files at ``out_level`` that the
    finalize step will publish atomically.  ``next_key`` (hex) is the
    first merged key not yet written — resume re-merges the inputs and
    skips everything below it.  ``drop_tombstones`` is decided once at
    merge start (whether any level deeper than ``out_level`` remains)
    and frozen here so a resume after an unrelated spill cannot change
    the merge's semantics mid-flight."""

    level: int
    out_level: int
    inputs: list[str] = field(default_factory=list)
    outputs: list[SegmentMeta] = field(default_factory=list)
    next_key: str = ""
    drop_tombstones: bool = False


@dataclass
class Manifest:
    segments: list[SegmentMeta] = field(default_factory=list)
    next_seg: int = 1
    epoch: int = 0
    device_epoch: int = 0
    pending_inval: list[str] = field(default_factory=list)
    compaction: CompactionState | None = None

    def alloc_segment(self) -> str:
        """Reserve the next (never-reused) segment file name."""
        name = f"seg_{self.next_seg:06d}.seg"
        self.next_seg += 1
        return name

    def segment_names(self) -> list[str]:
        """Live file names, chronological order."""
        return [m.name for m in self.segments]

    def level_counts(self) -> dict[int, int]:
        """→ ``{level: number of live segments}`` (ascending levels)."""
        out: dict[int, int] = {}
        for m in self.segments:
            out[m.level] = out.get(m.level, 0) + 1
        return dict(sorted(out.items()))


def _meta_from_json(o: object) -> SegmentMeta:
    if isinstance(o, str):                       # format 1: bare file name
        return SegmentMeta(name=o, level=0)
    assert isinstance(o, dict)
    return SegmentMeta(
        name=str(o["name"]),
        level=int(o.get("level", 0)),
        records=int(o.get("records", 0)),
        bytes=int(o.get("bytes", 0)),
        min_key=str(o.get("min_key", "")),
        max_key=str(o.get("max_key", "")),
        bloom_k=int(o.get("bloom_k", 0)),
        bloom_bits=int(o.get("bloom_bits", 0)),
    )


def _compaction_from_json(o: object) -> CompactionState | None:
    if o is None:
        return None
    assert isinstance(o, dict)
    return CompactionState(
        level=int(o["level"]),
        out_level=int(o["out_level"]),
        inputs=[str(n) for n in o.get("inputs", [])],
        outputs=[_meta_from_json(s) for s in o.get("outputs", [])],
        next_key=str(o.get("next_key", "")),
        drop_tombstones=bool(o.get("drop_tombstones", False)),
    )


def load(dirname: str) -> Manifest:
    """Read ``MANIFEST.json`` (any schema version); empty manifest if
    the file does not exist (a fresh store directory)."""
    path = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(path):
        return Manifest()
    with open(path, "r", encoding="utf-8") as f:
        o = json.load(f)
    return Manifest(
        segments=[_meta_from_json(s) for s in o.get("segments", [])],
        next_seg=int(o.get("next_seg", 1)),
        epoch=int(o.get("epoch", 0)),
        device_epoch=int(o.get("device_epoch", 0)),
        pending_inval=list(o.get("pending_inval", [])),
        compaction=_compaction_from_json(o.get("compaction")),
    )


def store(dirname: str, m: Manifest, sync: bool = True) -> None:
    """Atomic commit: serialize to ``MANIFEST.json.tmp``, fsync, rename.
    Always writes the current (format 3) schema — this is where older
    manifests migrate."""
    path = os.path.join(dirname, MANIFEST_NAME)
    tmp = path + ".tmp"
    payload = json.dumps({
        "format": FORMAT,
        "segments": [asdict(s) for s in m.segments],
        "next_seg": m.next_seg,
        "epoch": m.epoch,
        "device_epoch": m.device_epoch,
        "pending_inval": m.pending_inval,
        "compaction": None if m.compaction is None else asdict(m.compaction),
    }, sort_keys=True)
    with open(tmp, "w", encoding="utf-8") as f:
        FP.write("manifest.write", f, payload)
        f.flush()
        if sync:
            FP.hit("manifest.fsync")
            os.fsync(f.fileno())
    FP.hit("manifest.replace")
    os.replace(tmp, path)
    if sync:
        # the rename itself is directory metadata: without this fsync a
        # power loss after the WAL truncates could resurrect the OLD
        # manifest and lose the spilled segment
        from .wal import fsync_dir
        fsync_dir(dirname)


def sweep_orphans(dirname: str, m: Manifest) -> list[str]:
    """Delete ``seg_*.seg`` files not referenced by the manifest (debris
    from a crash between segment/merge write and manifest swap).  A
    paused merge's output partitions are referenced by ``compaction``
    rather than ``segments`` — they are live work, not debris."""
    live = set(m.segment_names())
    if m.compaction is not None:
        live.update(o.name for o in m.compaction.outputs)
    removed = []
    for name in sorted(os.listdir(dirname)):
        if name.endswith(".seg") and name not in live:
            os.remove(os.path.join(dirname, name))
            removed.append(name)
    return removed

"""Write-ahead log: length-prefixed, CRC-checksummed append records with
group commit at planner-wave boundaries.

Record framing (little-endian)::

    record := crc32(body) u32 | len(body) u32 | body
    body   := kind u8 | payload

Kinds::

    PUT     key_len u32 | key | value          one engine upsert
    DEL     key                                one engine tombstone
    INV     path (utf-8)                       invalidation-bus publish journal
    DEVMARK epoch u64                          device tier applied through epoch
    COMMIT  epoch u64                          group-commit marker

Appends buffer in memory; ``commit(epoch)`` writes the whole buffered
batch plus one COMMIT marker in a single OS write and then flushes (and
fsyncs, unless ``sync="none"``).  Because planner waves call commit
exactly once — at ``QueryEngine.refresh()`` — WAL batch boundaries align
with epoch boundaries: a crash loses at most the uncommitted wave, never
part of one.

``replay()`` walks the log, verifying every CRC; records past the last
valid COMMIT (an uncommitted wave, a torn write, or a corrupt tail) are
reported via ``valid_end`` so the recovering engine can truncate them.

Note: the WAL deliberately knows nothing about compaction levels — a
record's level placement is decided at spill/merge time and recorded in
the manifest, so the COMMIT framing needed no change for the leveled
tier (replay always lands records in the memtable, i.e. above level 0).
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

from .. import obs
from . import failpoints as FP

PUT = 1
DEL = 2
INV = 3
DEVMARK = 4
COMMIT = 5

_HDR = struct.Struct("<II")      # crc32(body), len(body)
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

#: ``REPRO_WAL_SYNC`` values: "fsync" (default — durable against power
#: loss), "none" (flush to the OS only; the CI knob for stable timings)
SYNC_ENV = "REPRO_WAL_SYNC"


def sync_mode(explicit: str | None = None) -> str:
    mode = explicit if explicit is not None else os.environ.get(SYNC_ENV, "fsync")
    if mode not in ("fsync", "none"):
        raise ValueError(f"unknown WAL sync mode {mode!r} (want 'fsync' or 'none')")
    return mode


def fsync_dir(dirname: str) -> None:
    """fsync the directory entry itself — a rename or newly created file
    is only power-loss durable once its directory metadata is on disk."""
    fd = os.open(dirname, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _frame(body: bytes) -> bytes:
    return _HDR.pack(zlib.crc32(body) & 0xFFFFFFFF, len(body)) + body


@dataclass(frozen=True)
class WALRecord:
    kind: int
    key: bytes = b""
    value: bytes = b""
    epoch: int = 0

    @property
    def path(self) -> str:
        """INV payload decoded (paths are utf-8 by construction)."""
        return self.key.decode("utf-8")


class WAL:
    """Append side of the log.  Thread safety is the caller's (DurableKV
    serializes all mutations under its own lock)."""

    def __init__(self, path: str, sync: str | None = None):
        self.path = path
        self.sync = sync_mode(sync)
        self._buf = bytearray()
        self._f = open(path, "ab")

    # -- buffered appends (group-committed) ---------------------------------
    def append_put(self, key: bytes, value: bytes) -> None:
        """Buffer one upsert record (durable at the next ``commit``)."""
        FP.hit("wal.append")
        self._buf += _frame(bytes([PUT]) + _U32.pack(len(key)) + key + value)

    def append_delete(self, key: bytes) -> None:
        """Buffer one tombstone record for ``key``."""
        FP.hit("wal.append")
        self._buf += _frame(bytes([DEL]) + key)

    def append_inval(self, path: str) -> None:
        """Buffer one invalidation-bus publish (device rehydration journal)."""
        FP.hit("wal.append")
        self._buf += _frame(bytes([INV]) + path.encode("utf-8"))

    def append_devmark(self, epoch: int) -> None:
        """Buffer a DEVMARK: device tier has applied through ``epoch``."""
        FP.hit("wal.append")
        self._buf += _frame(bytes([DEVMARK]) + _U64.pack(epoch))

    def pending_bytes(self) -> int:
        """Bytes buffered since the last ``commit`` (0 ⇒ wave is clean)."""
        return len(self._buf)

    # -- group commit -------------------------------------------------------
    def seal(self, epoch: int) -> bytes:
        """Freeze the buffered wave + its COMMIT marker into one byte
        string and clear the buffer — the synchronous half of a commit.
        The caller owns writing the sealed bytes (``write_sealed``);
        until it does, the wave is neither durable nor lost: appends for
        the *next* wave can start buffering immediately, which is what
        lets a pipelined commit overlap wave e's fsync with wave e+1's
        compute."""
        self._buf += _frame(bytes([COMMIT]) + _U64.pack(epoch))
        sealed = bytes(self._buf)
        self._buf.clear()
        return sealed

    def write_sealed(self, sealed: bytes, epoch: int) -> None:
        """One OS write for a sealed wave, then flush (+fsync) — the
        (possibly off-thread) durability half.  The commit marker inside
        ``sealed`` is what makes the wave real: replay drops everything
        after the last valid COMMIT."""
        with obs.span("wal.commit", epoch=epoch, bytes=len(sealed)):
            FP.write("wal.commit", self._f, sealed)
            self._f.flush()
            if self.sync == "fsync":
                with obs.span("wal.fsync"):
                    FP.hit("wal.fsync")
                    os.fsync(self._f.fileno())

    def commit(self, epoch: int) -> None:
        """Synchronous group commit: seal + write + flush (+fsync)."""
        self.write_sealed(self.seal(epoch), epoch)

    def truncate(self) -> None:
        """Truncate the log *file*, preserving any buffered-but-unsealed
        appends (called after a memtable spill: every committed record
        now lives in a segment; the manifest swap made that real.  Under
        a pipelined commit the spill runs off-thread while the next wave
        is already buffering — those records must survive)."""
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.flush()
        if self.sync == "fsync":
            os.fsync(self._f.fileno())

    def reset(self) -> None:
        """Truncate the log and drop the buffer (full reset)."""
        self._buf.clear()
        self.truncate()

    def close(self) -> None:
        """Release the file handle (buffered, uncommitted records drop —
        exactly the crash semantics a real crash would have)."""
        self._f.close()


def _parse_body(body: bytes) -> WALRecord:
    kind = body[0]
    payload = body[1:]
    if kind == PUT:
        (klen,) = _U32.unpack_from(payload)
        key = payload[4:4 + klen]
        return WALRecord(PUT, key=key, value=payload[4 + klen:])
    if kind == DEL:
        return WALRecord(DEL, key=payload)
    if kind == INV:
        return WALRecord(INV, key=payload)
    if kind in (DEVMARK, COMMIT):
        (epoch,) = _U64.unpack_from(payload)
        return WALRecord(kind, epoch=epoch)
    raise ValueError(f"unknown WAL record kind {kind}")


@dataclass
class ReplayResult:
    """Outcome of a WAL scan: committed waves only.

    ``valid_end`` is the byte offset just past the last valid COMMIT —
    the recovering engine truncates the file there, dropping both torn
    tails (CRC/length mismatch) and uncommitted waves.
    """

    waves: list[list[WALRecord]]
    valid_end: int
    dropped_records: int   # records read but past the last commit
    corrupt_tail: bool     # CRC mismatch / torn frame detected


def replay(path: str) -> ReplayResult:
    """Scan the log at ``path`` and return its committed waves (see
    :class:`ReplayResult`); a missing file replays as empty."""
    waves: list[list[WALRecord]] = []
    current: list[WALRecord] = []
    valid_end = 0
    dropped = 0
    corrupt = False
    if not os.path.exists(path):
        return ReplayResult(waves, 0, 0, False)
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + _HDR.size <= len(data):
        crc, blen = _HDR.unpack_from(data, off)
        body = data[off + _HDR.size: off + _HDR.size + blen]
        # blen == 0 passes the CRC check (crc32(b"") == 0) but no valid
        # record is empty — a zero-filled torn page, treat as corrupt
        if blen == 0 or len(body) < blen or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            corrupt = True
            break
        try:
            rec = _parse_body(body)
        except (ValueError, IndexError, struct.error):
            corrupt = True
            break
        off += _HDR.size + blen
        if rec.kind == COMMIT:
            current.append(rec)
            waves.append(current)
            current = []
            valid_end = off
        else:
            current.append(rec)
    # a partial header at EOF is a normal torn tail, not corruption
    if off + _HDR.size > len(data) and off < len(data):
        corrupt = True
    dropped = len(current)
    return ReplayResult(waves, valid_end, dropped, corrupt)



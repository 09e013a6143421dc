"""On-disk sorted segment files (SSTables): sparse index, per-segment
bloom filter, and an optional shared block cache.

A segment is a frozen sorted run spilled from the memtable (or merged by
compaction), tombstones included — a delete must shadow older levels
until a merge proves nothing older remains.

Layout, format v2 (little-endian; documented byte-for-byte in
docs/STORAGE.md and asserted against real files by
``tests/test_storage.py::test_segment_footer_matches_documented_layout``)::

    magic  b"WSEG1\\n"
    data   N records: key_len u32 | val_len u32 | key | value
           (val_len == 0xFFFFFFFF encodes a tombstone; no value bytes)
    index  every SPARSE_EVERY-th record: key_len u32 | key | offset u64
    bloom  ceil(bloom_nbits / 8) raw filter bytes
    footer index_off u64 | bloom_off u64 | n_index u32 | n_records u32
           | bloom_k u32 | bloom_nbits u64 | magic b"WEND2\\n"

Format v1 (PR 3) is the same without the bloom section and with the
short footer ``index_off u64 | n_index u32 | n_records u32 | b"WEND1\\n"``.
``SSTable`` reads both: the trailing magic selects the footer shape, and
a v1 segment simply has ``bloom is None`` (every probe must touch it).
``write_sstable(..., bloom_bits_per_key=0)`` still emits v1 bytes — that
is the compatibility writer the migration tests use.

Reads mmap the file: ``get`` is a bisect over the sparse index plus a
short forward scan (≤ SPARSE_EVERY records) — the LevelDB read shape.
With a ``BlockCache`` attached, the index block covering the key is
parsed once and served from memory afterwards (hot paths skip the mmap
entirely).  ``scan`` seeks to the index block covering the prefix and
walks records in key order, yielding tombstones for the merge layer to
resolve; scans never populate the cache (no pollution from range reads).
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import mmap
import os
import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from . import failpoints as FP

#: process-unique SSTable open ids — the generation component of block
#: cache keys (see :class:`BlockCache`)
_OPEN_IDS = itertools.count(1)

MAGIC = b"WSEG1\n"
END_MAGIC_V1 = b"WEND1\n"
END_MAGIC = b"WEND2\n"
SPARSE_EVERY = 16
_TOMB_LEN = 0xFFFFFFFF

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_KV = struct.Struct("<II")
_FOOTER_V1 = struct.Struct("<QII")    # index_off, n_index, n_records
#: v2 footer: index_off, bloom_off, n_index, n_records, bloom_k, bloom_nbits
_FOOTER = struct.Struct("<QQIIIQ")

#: sentinel for an on-disk delete; distinct from "key absent" (None is
#: never returned by segment lookups — absence is reported as MISSING)
TOMBSTONE = object()
MISSING = object()


# ---------------------------------------------------------------------------
# bloom filter
# ---------------------------------------------------------------------------
def bloom_hash_pair(key: bytes) -> tuple[int, int]:
    """Two independent 64-bit hashes of ``key`` for double hashing.

    Probe ``i`` lands at ``(h1 + i*h2) % nbits`` — the standard
    Kirsch–Mitzenmacher construction, so one digest serves every probe of
    every segment's filter (``DurableKV.get`` hashes the key once per
    lookup, not once per segment)."""
    d = hashlib.blake2b(key, digest_size=16).digest()
    h1 = int.from_bytes(d[:8], "little")
    h2 = int.from_bytes(d[8:], "little") | 1      # odd: full-period stride
    return h1, h2


class BloomFilter:
    """k-hash bloom filter over a segment's keys (tombstone keys too —
    a deleted key must still be *findable* so its tombstone can shadow
    older levels).

    Args: ``nbits`` filter width in bits, ``k`` probes per key, ``bits``
    the backing ``bytearray``/``bytes`` of ``ceil(nbits/8)`` bytes."""

    __slots__ = ("nbits", "k", "bits")

    def __init__(self, nbits: int, k: int, bits: bytes | bytearray):
        self.nbits = nbits
        self.k = k
        self.bits = bits

    @classmethod
    def build(cls, keys, bits_per_key: int) -> "BloomFilter":
        """Size a filter for ``keys`` at ``bits_per_key`` and populate it.
        ``k`` follows the optimum ``bits_per_key · ln 2`` (≈0.7/bit)."""
        n = max(1, len(keys))
        nbits = max(64, n * bits_per_key)
        k = max(1, min(30, round(bits_per_key * 0.69)))
        bits = bytearray((nbits + 7) // 8)
        for key in keys:
            h1, h2 = bloom_hash_pair(key)
            for i in range(k):
                pos = (h1 + i * h2) % nbits
                bits[pos >> 3] |= 1 << (pos & 7)
        return cls(nbits, k, bits)

    def may_contain_hashes(self, h1: int, h2: int) -> bool:
        """Membership test from a precomputed :func:`bloom_hash_pair`."""
        nbits, bits = self.nbits, self.bits
        for i in range(self.k):
            pos = (h1 + i * h2) % nbits
            if not bits[pos >> 3] & (1 << (pos & 7)):
                return False
        return True

    def may_contain(self, key: bytes) -> bool:
        """Membership test (no false negatives; FPR ≈ 0.6^(k) at the
        designed load — property-tested in tests/test_storage.py)."""
        return self.may_contain_hashes(*bloom_hash_pair(key))


# ---------------------------------------------------------------------------
# block cache
# ---------------------------------------------------------------------------
class BlockCache:
    """Shared LRU cache of parsed index blocks, bounded by a byte budget.

    One instance is shared across every shard of a ``ShardedPathStore``
    (``open_durable_store`` creates it), so the budget is global: hot
    shards can use more than their share.  Keys are
    ``(segment_path, file_id, block_index)`` where ``file_id`` is a
    process-unique id minted per SSTable open.  ``Manifest.next_seg``
    keeps names unique *within* one manifest lineage, but a cache can
    outlive a lineage (a store directory recreated after a crash test,
    or a restore-from-backup, re-allocates ``seg_000001.seg`` at the
    same path) — and inode numbers can be recycled by the filesystem,
    so neither path nor inode distinguishes segment generations.  The
    open id does: a stale parsed block can never be served for a
    replacement file.
    Entries are dropped eagerly on segment close and age out via LRU
    otherwise.  Thread-safe (its own lock: per-shard ``DurableKV`` locks
    do not protect cross-shard sharing).
    """

    def __init__(self, capacity_bytes: int = 8 << 20):
        self.capacity = capacity_bytes
        self._lock = threading.Lock()
        self._d: "OrderedDict[tuple[str, int, int], tuple[list, int]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple[str, int, int]):
        """→ cached parsed block (list of ``(key, value)``), or None."""
        with self._lock:
            ent = self._d.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return ent[0]

    def put(self, key: tuple[str, int, int], block: list, nbytes: int) -> None:
        """Insert a parsed block charged at ``nbytes``; evicts LRU entries
        until the budget holds.  A block larger than the whole budget is
        simply not cached."""
        if nbytes > self.capacity:
            return
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._d[key] = (block, nbytes)
            self._bytes += nbytes
            while self._bytes > self.capacity and self._d:
                _, (_, evicted) = self._d.popitem(last=False)
                self._bytes -= evicted

    def drop_segment(self, path: str) -> int:
        """Evict every block of one segment (called when a compaction
        deletes its file); returns the number of entries dropped."""
        with self._lock:
            stale = [k for k in self._d if k[0] == path]
            for k in stale:
                self._bytes -= self._d.pop(k)[1]
            return len(stale)

    def used_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._d)


# ---------------------------------------------------------------------------
# write side
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SegmentStats:
    """What ``write_sstable`` measured while writing — the manifest
    summary for the new segment (level is assigned by the caller)."""

    n_records: int
    file_bytes: int
    min_key: bytes
    max_key: bytes
    bloom_k: int
    bloom_nbits: int


def write_sstable(path: str, items: list[tuple[bytes, object]],
                  sync: bool = True,
                  bloom_bits_per_key: int = 10) -> SegmentStats:
    """Write sorted ``(key, value | TOMBSTONE)`` items as one segment.

    Args: ``path`` target file, ``items`` sorted unique-key pairs,
    ``sync`` fsync file + directory entry, ``bloom_bits_per_key`` filter
    budget (0 → no filter, v1/PR-3 byte layout).  Returns the
    :class:`SegmentStats` the caller records in the manifest.

    Writes to ``path`` directly; the caller makes the segment *live* only
    via the manifest swap, so a torn segment file is unreachable garbage,
    never corruption.
    """
    buf = bytearray(MAGIC)
    index: list[tuple[bytes, int]] = []
    for i, (key, value) in enumerate(items):
        if i % SPARSE_EVERY == 0:
            index.append((key, len(buf)))
        if value is TOMBSTONE:
            buf += _KV.pack(len(key), _TOMB_LEN) + key
        else:
            buf += _KV.pack(len(key), len(value)) + key + value
    index_off = len(buf)
    for key, off in index:
        buf += _U32.pack(len(key)) + key + _U64.pack(off)
    if bloom_bits_per_key > 0:
        bloom = BloomFilter.build([k for k, _ in items], bloom_bits_per_key)
        bloom_off = len(buf)
        buf += bytes(bloom.bits)
        buf += _FOOTER.pack(index_off, bloom_off, len(index), len(items),
                            bloom.k, bloom.nbits) + END_MAGIC
        bloom_k, bloom_nbits = bloom.k, bloom.nbits
    else:
        buf += _FOOTER_V1.pack(index_off, len(index), len(items)) + END_MAGIC_V1
        bloom_k = bloom_nbits = 0
    with open(path, "wb") as f:
        FP.write("segment.write", f, bytes(buf))
        f.flush()
        if sync:
            FP.hit("segment.fsync")
            os.fsync(f.fileno())
    if sync:
        # the new file's directory entry must hit disk before the
        # manifest swap advertises it
        from .wal import fsync_dir
        fsync_dir(os.path.dirname(path) or ".")
    return SegmentStats(
        n_records=len(items), file_bytes=len(buf),
        min_key=items[0][0] if items else b"",
        max_key=items[-1][0] if items else b"",
        bloom_k=bloom_k, bloom_nbits=bloom_nbits)


# ---------------------------------------------------------------------------
# read side
# ---------------------------------------------------------------------------
class SSTable:
    """Read side of one immutable segment file (v1 or v2 layout).

    Args: ``path`` segment file; ``cache`` an optional shared
    :class:`BlockCache` (point gets parse whole index blocks through it);
    ``stat`` an optional ``Callable[[str], None]`` counter hook the
    owning engine uses for per-engine ``cache_hit``/``cache_miss``
    accounting (the cache itself keeps only global totals).
    """

    def __init__(self, path: str, cache: "BlockCache | None" = None,
                 stat: Optional[Callable[[str], None]] = None):
        self.path = path
        self._cache = cache
        self._stat = stat
        self._f = open(path, "rb")
        # per-open cache identity: a recreated file at the same path (a
        # new store generation) must never hit the old file's blocks,
        # and inode numbers can be recycled — a process-unique open id
        # cannot collide within the (in-process) cache's lifetime
        self._file_id = next(_OPEN_IDS)
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:          # zero-length file cannot be mmapped
            self._f.close()
            raise CorruptSegment(f"empty segment file {path!r}")
        mm = self._mm
        tail = bytes(mm[-len(END_MAGIC):]) if len(mm) >= len(END_MAGIC) else b""
        self.bloom: BloomFilter | None = None
        if tail == END_MAGIC:
            foot_at = len(mm) - _FOOTER.size - len(END_MAGIC)
            if foot_at < len(MAGIC) or mm[:len(MAGIC)] != MAGIC:
                self.close()
                raise CorruptSegment(f"bad segment framing in {path!r}")
            (self._index_off, bloom_off, n_index, self.n_records,
             bloom_k, bloom_nbits) = _FOOTER.unpack_from(mm, foot_at)
            if bloom_nbits:
                bits = bytes(mm[bloom_off:bloom_off + (bloom_nbits + 7) // 8])
                self.bloom = BloomFilter(bloom_nbits, bloom_k, bits)
        elif tail == END_MAGIC_V1:
            foot_at = len(mm) - _FOOTER_V1.size - len(END_MAGIC_V1)
            if foot_at < len(MAGIC) or mm[:len(MAGIC)] != MAGIC:
                self.close()
                raise CorruptSegment(f"bad segment framing in {path!r}")
            self._index_off, n_index, self.n_records = \
                _FOOTER_V1.unpack_from(mm, foot_at)
        else:
            self.close()
            raise CorruptSegment(f"bad segment framing in {path!r}")
        self._idx_keys: list[bytes] = []
        self._idx_offs: list[int] = []
        off = self._index_off
        for _ in range(n_index):
            (klen,) = _U32.unpack_from(mm, off)
            off += 4
            self._idx_keys.append(bytes(mm[off:off + klen]))
            off += klen
            (doff,) = _U64.unpack_from(mm, off)
            off += 8
            self._idx_offs.append(doff)

    # ------------------------------------------------------------------
    def _read_record(self, off: int) -> tuple[bytes, object, int]:
        klen, vlen = _KV.unpack_from(self._mm, off)
        off += _KV.size
        key = bytes(self._mm[off:off + klen])
        off += klen
        if vlen == _TOMB_LEN:
            return key, TOMBSTONE, off
        return key, bytes(self._mm[off:off + vlen]), off + vlen

    def _block_bounds(self, block: int) -> tuple[int, int]:
        end = (self._idx_offs[block + 1] if block + 1 < len(self._idx_offs)
               else self._index_off)
        return self._idx_offs[block], end

    def _load_block(self, block: int) -> list[tuple[bytes, object]]:
        """Parse (or fetch from the cache) one index block — the ≤
        SPARSE_EVERY records between two sparse-index entries."""
        ck = (self.path, self._file_id, block)
        cached = self._cache.get(ck)        # type: ignore[union-attr]
        if cached is not None:
            if self._stat:
                self._stat("cache_hit")
            return cached
        if self._stat:
            self._stat("cache_miss")
        off, end = self._block_bounds(block)
        entries: list[tuple[bytes, object]] = []
        nbytes = 64
        while off < end:
            k, v, off = self._read_record(off)
            entries.append((k, v))
            nbytes += len(k) + (len(v) if isinstance(v, bytes) else 0) + 48
        self._cache.put(ck, entries, nbytes)  # type: ignore[union-attr]
        return entries

    def get(self, key: bytes) -> object:
        """Point lookup → value bytes, TOMBSTONE, or MISSING.

        O(log n_index) bisect + one block: a cached parsed block when a
        ``BlockCache`` is attached, else a ≤ SPARSE_EVERY-record forward
        scan off the mmap."""
        if not self._idx_keys or key < self._idx_keys[0]:
            return MISSING
        block = bisect.bisect_right(self._idx_keys, key) - 1
        if self._cache is not None:
            for k, v in self._load_block(block):
                if k == key:
                    return v
                if k > key:
                    break
            return MISSING
        off, end = self._block_bounds(block)
        while off < end:
            k, v, off = self._read_record(off)
            if k == key:
                return v
            if k > key:
                break
        return MISSING

    def scan(self, prefix: bytes) -> Iterator[tuple[bytes, object]]:
        """Yield (key, value | TOMBSTONE) for keys with ``prefix``, in key
        order.  Tombstones are yielded — shadowing is the merge layer's
        job, not the segment's.  Never touches the block cache."""
        if self._idx_keys:
            block = max(0, bisect.bisect_right(self._idx_keys, prefix) - 1)
            off = self._idx_offs[block]
        else:
            off = len(MAGIC)
        while off < self._index_off:
            k, v, off = self._read_record(off)
            if k.startswith(prefix):
                yield k, v
            elif k > prefix:
                return

    def iter_all(self) -> Iterator[tuple[bytes, object]]:
        """Yield every record oldest-file-order (compaction's merge input)."""
        off = len(MAGIC)
        while off < self._index_off:
            k, v, off = self._read_record(off)
            yield k, v

    def close(self) -> None:
        """Release the mmap/file handle and evict this segment's cached
        blocks (safe to call twice)."""
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        self._f.close()
        if self._cache is not None:
            self._cache.drop_segment(self.path)


class CorruptSegment(RuntimeError):
    """Segment framing/footer validation failed (torn or foreign file)."""

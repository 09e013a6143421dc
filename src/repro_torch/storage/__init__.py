"""Durable storage tier: WAL + leveled SSTable segments + manifest
behind the ``KVEngine`` protocol, with per-segment bloom filters, a
shared block cache, crash recovery, and the epoch / invalidation journal
the device tier rehydrates from.  See docs/STORAGE.md for the on-disk
layout, compaction state machine, and recovery protocol; docs/ARCHITECTURE.md
places this tier in the full system."""
from .lsm import (DurableKV, default_block_cache, durable_engine_factory,
                  open_durable_store)
from .sstable import (BlockCache, BloomFilter, SegmentStats, SSTable,
                      write_sstable)
from .wal import WAL, replay

__all__ = ["DurableKV", "durable_engine_factory", "open_durable_store",
           "default_block_cache", "BlockCache", "BloomFilter",
           "SegmentStats", "SSTable", "write_sstable", "WAL", "replay"]

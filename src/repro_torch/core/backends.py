"""Comparison storage backends for the Table II study (paper §VI-B).

Four backends behind one ``Backend`` protocol, each the idiomatic
realization of the wiki on that storage model:

* ``WikiKVBackend``   — the paper's path-as-key layout over the MemKV LSM
                        engine (our method).
* ``FSBackend``       — hierarchical file system: directories are directories,
                        records are files; Q2 enumerates via readdir; Q4 walks.
* ``SQLBackend``      — relational (sqlite ≈ PostgreSQL+ltree): a normalized
                        nodes(path, parent, data) table with indexes; Q2 is a
                        parent-equality SELECT, Q3 indexed equality per level,
                        Q4 a range predicate on the path index.
* ``GraphBackend``    — property-graph (≈ Neo4j): node store + typed adjacency;
                        Q1 resolves by *traversing edges from the root* (the
                        Cypher path-match contract — no direct path index),
                        Q2 expands outgoing edges, Q4 pattern-matches on a
                        node-name scan.

Every backend is loaded from the same list of (path, record) pairs so the
latency comparison isolates the storage model, as in the paper's controlled
in-process setup.
"""
from __future__ import annotations

import os
import shutil
import sqlite3
import tempfile
from typing import Optional, Sequence

from . import paths as P
from . import records as R
from ..device import resolve_device
from .engine import DeviceEngine, HostEngine, ShardedPathStore
from .store import MemKV, PathStore


class Backend:
    name = "abstract"

    def load(self, items: Sequence[tuple[str, R.Record]]) -> None:
        raise NotImplementedError

    def q1_get(self, path: str) -> Optional[R.Record]:
        raise NotImplementedError

    def q2_ls(self, path: str) -> Optional[list[str]]:
        raise NotImplementedError

    def q3_navigate(self, path: str) -> list[R.Record]:
        raise NotImplementedError

    def q4_search(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class WikiKVBackend(Backend):
    """Path-as-key layout, served through the unified ``QueryEngine``
    (core/engine.py).  Variants differ only in the engine behind the same
    Q1–Q4 contract:

    * ``wikikv``         — HostEngine over one MemKV LSM (the paper's layout)
    * ``wikikv_sharded`` — HostEngine over the digest-range ShardedPathStore
    * ``wikikv_device``  — DeviceEngine over the frozen tensor index
                           (CUDA kernels on a card, plain versions on a CPU device)
    * ``wikikv_durable`` — HostEngine over the on-disk WAL + SSTable tier
                           (storage.DurableKV; reads hit real segment files)
    """

    name = "wikikv"
    engine_kind = "host"
    n_shards = 1

    def __init__(self):
        if self.n_shards > 1:
            self.store = ShardedPathStore(n_shards=self.n_shards)
        else:
            self.store = PathStore(MemKV())
        self.engine = None

    def load(self, items):
        for path, rec in items:
            self.store.put_record(path, rec)
        self.store.flush()
        if self.engine_kind == "device":
            self.engine = DeviceEngine.from_store(self.store, device=self.device)
        else:
            self.engine = HostEngine(self.store)

    def q1_get(self, path):
        return self.engine.q1_get([path])[0]

    def q2_ls(self, path):
        out = self.engine.q2_ls([path])[0]
        return None if out is None else out[1]

    def q3_navigate(self, path):
        return self.engine.q3_navigate([path])[0]

    def q4_search(self, prefix):
        return self.engine.q4_search([prefix])[0]

    # batched entry points (the Table II amortization rows)
    def q1_get_batch(self, paths):
        return self.engine.q1_get(paths)

    def q4_search_batch(self, prefixes):
        return self.engine.q4_search(prefixes)


class WikiKVShardedBackend(WikiKVBackend):
    name = "wikikv_sharded"
    n_shards = 4


class WikiKVDeviceBackend(WikiKVBackend):
    name = "wikikv_device"
    engine_kind = "device"

    def __init__(self, device=None):
        # the torch device every entry point takes: None means cuda and
        # raises when no card is visible
        self.device = resolve_device(device)
        super().__init__()


class WikiKVDurableBackend(WikiKVBackend):
    """Path-as-key layout over the durable LSM tier: every record lives
    in WAL + on-disk SSTable segments, and the load ends with a spill +
    full compaction so the measured read path is one real segment file
    (mmap'd sparse-index lookups), not a warm memtable in disguise.
    Runs the serving configuration ``open_durable_store`` wires up —
    default bloom bits and the shared block cache (the cold, cache-less
    read path is measured separately by ``wikikv_durable_cold``).
    Honors ``REPRO_WAL_SYNC`` (CI sets ``none`` for stable timings)."""

    name = "wikikv_durable"

    def __init__(self):
        from ..storage import DurableKV, default_block_cache
        self._dir = tempfile.mkdtemp(prefix="wikikv_durable_")
        self.store = PathStore(DurableKV(self._dir,
                                         block_cache=default_block_cache()))
        self.engine = None

    def load(self, items):
        for path, rec in items:
            self.store.put_record(path, rec)
        self.store.flush()
        self.store.compact()
        self.engine = HostEngine(self.store)

    def close(self):
        self.store.close()
        shutil.rmtree(self._dir, ignore_errors=True)


class FSBackend(Backend):
    """Directories/files on the real filesystem.

    A node at path π is stored as ``<root>/π/.node`` if it is a directory
    record (so it can have children), or ``<root>/π`` as a plain file.
    """

    name = "fs"

    def __init__(self, root: str | None = None):
        self._own = root is None
        self.root = root or tempfile.mkdtemp(prefix="wikikv_fs_")

    def _fs(self, path: str) -> str:
        return os.path.join(self.root, *P.segments(path))

    def load(self, items):
        for path, rec in items:
            fp = self._fs(path)
            if isinstance(rec, R.DirRecord):
                os.makedirs(fp, exist_ok=True)
                with open(os.path.join(fp, ".node"), "wb") as f:
                    f.write(R.encode(rec))
            else:
                os.makedirs(os.path.dirname(fp), exist_ok=True)
                with open(fp, "wb") as f:
                    f.write(R.encode(rec))

    def q1_get(self, path):
        fp = self._fs(path)
        try:
            if os.path.isdir(fp):
                with open(os.path.join(fp, ".node"), "rb") as f:
                    return R.decode(f.read())
            with open(fp, "rb") as f:
                return R.decode(f.read())
        except (FileNotFoundError, NotADirectoryError):
            return None

    def q2_ls(self, path):
        fp = self._fs(path)
        if not os.path.isdir(fp):
            return None
        out = []
        for name in sorted(os.listdir(fp)):
            if name == ".node":
                continue
            out.append(P.child(path, name))
        return out

    def q3_navigate(self, path):
        out = []
        for anc in list(P.ancestors(path)) + [path]:
            rec = self.q1_get(anc)
            if rec is None:
                break
            out.append(rec)
        return out

    def q4_search(self, prefix):
        base = self._fs(prefix)
        hits: list[str] = []
        if os.path.isdir(base):
            for dirpath, dirnames, filenames in os.walk(base):
                rel = os.path.relpath(dirpath, self.root)
                lp = P.ROOT if rel == "." else P.SEP + rel.replace(os.sep, P.SEP)
                hits.append(lp)
                for fn in filenames:
                    if fn != ".node":
                        hits.append(P.child(lp, fn))
        elif os.path.exists(base):
            hits.append(prefix)
        return sorted(hits)

    def close(self):
        if self._own:
            shutil.rmtree(self.root, ignore_errors=True)


class SQLBackend(Backend):
    """Relational layout: one normalized nodes table + parent index.

    Mirrors the paper's PostgreSQL+ltree baseline: Q1/Q3 are indexed path
    equality lookups, Q2 a parent-equality select, Q4 a range predicate
    on the path primary key (``path >= p AND path < p || U+10FFFF``), all
    through the SQL parse/plan path — the constant the paper measures.
    """

    name = "sql"

    def __init__(self):
        self.db = sqlite3.connect(":memory:")
        self.db.execute(
            "CREATE TABLE nodes (path TEXT PRIMARY KEY, parent TEXT, data BLOB)")
        self.db.execute("CREATE INDEX idx_parent ON nodes(parent)")

    def load(self, items):
        rows = []
        for path, rec in items:
            par = P.parent(path) if path != P.ROOT else None
            rows.append((path, par, R.encode(rec)))
        self.db.executemany("INSERT OR REPLACE INTO nodes VALUES (?,?,?)", rows)
        self.db.commit()

    def q1_get(self, path):
        cur = self.db.execute("SELECT data FROM nodes WHERE path = ?", (path,))
        row = cur.fetchone()
        return R.decode(row[0]) if row else None

    def q2_ls(self, path):
        if self.q1_get(path) is None:
            return None
        cur = self.db.execute(
            "SELECT path FROM nodes WHERE parent = ? ORDER BY path", (path,))
        return [r[0] for r in cur.fetchall()]

    def q3_navigate(self, path):
        out = []
        for anc in list(P.ancestors(path)) + [path]:
            rec = self.q1_get(anc)
            if rec is None:
                break
            out.append(rec)
        return out

    def q4_search(self, prefix):
        hi = prefix + "\U0010ffff"
        cur = self.db.execute(
            "SELECT path FROM nodes WHERE path >= ? AND path < ? ORDER BY path",
            (prefix, hi))
        return [r[0] for r in cur.fetchall()
                if P.is_prefix(prefix.rstrip(P.SEP) or P.ROOT, r[0])]

    def close(self):
        self.db.close()


class GraphBackend(Backend):
    """Property-graph layout: nodes by surrogate id, CHILD edges.

    Faithful to the graph-database contract the paper describes: there is
    *no* path index — Q1 must traverse the CHILD edges from the root,
    segment by segment (the Cypher ``MATCH (r)-[:CHILD*]->(n)`` plan), and
    Q4 has no native prefix primitive, so it scans node names.
    """

    name = "graph"

    def __init__(self):
        # node payloads stored SERIALIZED (wire-format parity with the
        # other backends — a property store marshals records too)
        self.nodes: dict[int, bytes] = {}
        self.names: dict[int, str] = {}
        self.edges: dict[int, dict[str, int]] = {}  # id -> {segment: child id}
        self.root_id = 0
        self._next = 1

    def load(self, items):
        ordered = sorted(items, key=lambda it: P.depth(it[0]))
        for path, rec in ordered:
            if path == P.ROOT:
                self.nodes[self.root_id] = R.encode(rec)
                self.names[self.root_id] = ""
                self.edges.setdefault(self.root_id, {})
                continue
            pid = self._resolve(P.parent(path))
            if pid is None:
                continue  # orphan — unreachable in a graph store
            seg = P.basename(path)
            nid = self.edges[pid].get(seg)
            if nid is None:
                nid = self._next
                self._next += 1
                self.edges[pid][seg] = nid
                self.edges.setdefault(nid, {})
            self.nodes[nid] = R.encode(rec)
            self.names[nid] = seg

    def _resolve(self, path: str) -> Optional[int]:
        nid = self.root_id
        for seg in P.segments(path):
            nxt = self.edges.get(nid, {}).get(seg)
            if nxt is None:
                return None
            nid = nxt
        return nid

    def q1_get(self, path):
        nid = self._resolve(path)
        if nid is None or nid not in self.nodes:
            return None
        return R.decode(self.nodes[nid])

    def q2_ls(self, path):
        nid = self._resolve(path)
        if nid is None:
            return None
        return [P.child(path, seg) for seg in sorted(self.edges.get(nid, {}))]

    def q3_navigate(self, path):
        out = []
        nid = self.root_id
        raw = self.nodes.get(nid)
        if raw is None:
            return out
        out.append(R.decode(raw))
        for seg in P.segments(path):
            nid2 = self.edges.get(nid, {}).get(seg)
            if nid2 is None or nid2 not in self.nodes:
                break
            nid = nid2
            out.append(R.decode(self.nodes[nid]))
        return out

    def q4_search(self, prefix):
        # no prefix primitive: BFS the whole graph materializing paths,
        # filter — the pattern-match emulation the paper describes.
        hits = []
        stack = [(self.root_id, P.ROOT)]
        while stack:
            nid, path = stack.pop()
            if P.is_prefix(prefix.rstrip(P.SEP) or P.ROOT, path):
                hits.append(path)
            for seg, cid in self.edges.get(nid, {}).items():
                stack.append((cid, P.child(path, seg)))
        return sorted(hits)


ALL_BACKENDS = {
    "wikikv": WikiKVBackend,
    "wikikv_sharded": WikiKVShardedBackend,
    "wikikv_device": WikiKVDeviceBackend,
    "wikikv_durable": WikiKVDurableBackend,
    "fs": FSBackend,
    "sql": SQLBackend,
    "graph": GraphBackend,
}

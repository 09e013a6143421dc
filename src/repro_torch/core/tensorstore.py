"""Device-resident tensorized path index — the WikiKV core on PyTorch.

Port of ``repro/core/tensorstore.py``.  The numpy layer (``TensorWiki``,
``_materialize``, ``freeze_with_records``, ``TensorDelta``,
``apply_delta_ex``, ``_try_patch``, ``logical_state``, ``pack_path``) is
the reference's, unchanged; the query helpers at the bottom call the
port's kernels through ``kernels.ops`` instead of jitted jnp references.

Layout (frozen from a PathStore snapshot by the offline pipeline).  Row
tables are allocated with *slack capacity* (a 128-row multiple, matching
the lookup tile) so small deltas patch rows in place instead of
re-materializing the whole table:

  keys_hi, keys_lo : (cap,) uint32 pairs — 64-bit FNV digests H(π) in
                     *row-id* order.  Rows 0..n_rows-1 are allocated
                     (live or tombstoned); free slots and tombstones hold
                     0xFFFFFFFF sentinels.  ``sort_perm`` lists the live
                     rows in (hi, lo) order — the view the lookup runs
                     over (as one int64 key per row, ``kernels.ops.key64``).
  path_tokens      : (cap, L) uint8 — normalized path bytes, zero-padded.
                     ``lex_order`` lists live rows in lexicographic path
                     order for prefix range scans.
  kinds            : (cap,) int8   — 0 dir, 1 file.
  access/depth     : (cap,) int32/int8 — co-located meta for evolution.
  child_index      : CSR (N0+1,) offsets into ``child_rows`` (int32 row
                     ids), packed at the last materialize; rows whose
                     child lists changed since then live in the
                     ``child_patch`` overlay (row -> tuple of child rows).
  dead             : (cap,) bool tombstone bitmap; ``row_of`` maps live
                     path -> row id.

Refresh modes (``apply_delta``): **patch** mutates rows in place for
small deltas; **rebuild/compact** is the full ``_materialize`` path.
Ownership: the patch path *consumes* its input snapshot — reader tiers
hold their own epoch view (engine.DeviceEngine).

Query ops (``kernels.ops`` dispatches: plain version for CPU tensors,
hand-written kernel for CUDA tensors):

  batched_get(paths)     → row ids (−1 for miss)        [Q1, batched]
  ls_rows(row)           → child row ids                [Q2]
  search_prefix(prefix)  → matching paths               [Q4]
  navigate_rows(path)    → row ids of the ancestor chain [Q3]
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from . import paths as P
from . import records as R
from .store import PathStore

MAX_PATH_BYTES = 96
#: row-table allocation granule — matches kernels.path_lookup.TILE so the
#: padded digest table is always kernel-eligible without re-padding
ROW_TILE = 128
#: digest value stored in free / tombstoned key slots: greater than every
#: real key (FNV of a non-empty path never yields 2^64−1), so the sorted
#: view stays searchable and sentinels can never satisfy a real query
KEY_SENTINEL = np.uint32(0xFFFFFFFF)

# -- patch-eligibility thresholds (apply_delta mode="auto") -----------------
#: deltas up to max(PATCH_MIN_DELTA, frac·n_live) rows patch in place
PATCH_MIN_DELTA = 16
PATCH_MAX_DELTA_FRAC = 0.25
#: compact (full rebuild) when tombstones would exceed this row fraction
PATCH_MAX_DEAD_FRAC = 0.25
#: compact when the children overlay outgrows max(64, n_live // 4) entries
PATCH_MIN_OVERLAY = 64


def _capacity(n: int) -> int:
    """Rows to allocate for n live rows: ≥ max(64, n/4) append slots,
    rounded up to the ROW_TILE granule."""
    want = n + max(64, n // 4)
    return -(-want // ROW_TILE) * ROW_TILE


def _digest_pair(path: str) -> tuple[int, int]:
    h = P.path_hash(path)
    return (h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF


def pack_path(path: str, width: int = MAX_PATH_BYTES) -> np.ndarray:
    b = path.encode("utf-8")[:width]
    out = np.zeros((width,), dtype=np.uint8)
    out[: len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


@dataclass
class TensorWiki:
    """Epoch snapshot of the device-resident wiki index (host master copy;
    the engine uploads/patches the device mirrors per epoch)."""

    keys_hi: np.ndarray         # (cap,) uint32 in row-id order (see module doc)
    keys_lo: np.ndarray         # (cap,) uint32
    path_tokens: np.ndarray     # (cap, L) uint8 in row-id order
    lex_order: np.ndarray       # (n_live,) int32 — live rows in lex path order
    lex_tokens: np.ndarray | None  # (n_live, L) uint8 lex-ordered; None after
                                   # a patch (derive via lex_token_matrix())
    kinds: np.ndarray           # (cap,) int8
    access: np.ndarray          # (cap,) int32
    depths: np.ndarray          # (cap,) int8
    child_offsets: np.ndarray   # (N0+1,) int32 CSR packed at last materialize
    child_rows: np.ndarray      # (E,) int32
    n_pinned: int               # live rows with depth <= 1 ("/" + dimensions)
    paths: list[str]            # row id -> path for rows 0..n_rows-1
    n_rows: int = 0             # allocated rows (live + tombstoned)
    sort_perm: np.ndarray | None = None   # (n_live,) int32, digest order
    dead: np.ndarray | None = None        # (cap,) bool tombstones
    n_dead: int = 0
    child_patch: dict = field(default_factory=dict)  # row -> tuple(child rows)
    row_of: dict = field(default_factory=dict)       # live path -> row id
    refresh_kind: str = "materialize"     # how this snapshot was produced

    @property
    def n(self) -> int:
        """Live row count (the logical table size)."""
        return self.n_rows - self.n_dead

    @property
    def cap(self) -> int:
        return int(self.keys_hi.shape[0])

    # -- views --------------------------------------------------------------
    def search_view(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys_hi, keys_lo, rows) of the live table in digest order —
        what binary search / the lookup kernel runs over.  A gather, not a
        sort: ``sort_perm`` is maintained incrementally by the patch path."""
        sp = self.sort_perm
        return self.keys_hi[sp], self.keys_lo[sp], sp

    def children_of(self, row: int) -> np.ndarray:
        """Child rows of a directory row: overlay entry if the row's list
        changed since the last materialize, packed CSR slice otherwise."""
        patched = self.child_patch.get(row)
        if patched is not None:
            return np.asarray(patched, dtype=np.int32)
        if row < len(self.child_offsets) - 1:
            lo, hi = int(self.child_offsets[row]), int(self.child_offsets[row + 1])
            return np.asarray(self.child_rows[lo:hi])
        return np.zeros((0,), dtype=np.int32)  # appended row, no overlay entry

    def live_mask(self) -> np.ndarray:
        return ~self.dead[: self.n_rows]

    def pinned_rows(self) -> np.ndarray:
        """Live rows of the L1 hot set ("/" + dimensions), row-id order."""
        return np.where((self.depths[: self.n_rows] <= 1)
                        & ~self.dead[: self.n_rows])[0].astype(np.int32)

    def lex_token_matrix(self) -> np.ndarray:
        """Lex-ordered token matrix; materialized lazily after a patch."""
        if self.lex_tokens is not None:
            return self.lex_tokens
        return self.path_tokens[self.lex_order]


def freeze(store: PathStore, max_path_bytes: int = MAX_PATH_BYTES) -> TensorWiki:
    """Snapshot a PathStore into the device-resident layout.

    Runs in the offline pipeline; the online tier swaps the frozen table
    atomically (the tensor-level analogue of the invalidation protocol —
    bounded staleness Δ = refresh cadence)."""
    return freeze_with_records(store, max_path_bytes)[0]


def freeze_with_records(store: PathStore,
                        max_path_bytes: int = MAX_PATH_BYTES
                        ) -> tuple[TensorWiki, list]:
    """``freeze`` plus the decoded records in row order — one store pass
    total, so engine.DeviceEngine snapshots don't pay 3×N point gets."""
    all_paths = sorted(store.all_paths())
    if not all_paths:
        raise ValueError("empty store")
    return _materialize(all_paths, [store.get(p) for p in all_paths],
                        max_path_bytes)


def _materialize(all_paths: list[str], all_recs: list,
                 max_path_bytes: int = MAX_PATH_BYTES
                 ) -> tuple[TensorWiki, list]:
    """Build the device layout from an in-memory (path, record) table —
    the shared tail of ``freeze_with_records`` (which sources records from
    a store pass) and ``apply_delta``'s rebuild/compact mode (which
    sources them from the previous snapshot + a TensorDelta, with zero
    store round trips)."""
    n = len(all_paths)
    if n == 0:
        raise ValueError("empty store")
    cap = _capacity(n)
    digests = np.zeros((n, 2), dtype=np.uint64)
    toks = np.zeros((cap, max_path_bytes), dtype=np.uint8)
    kinds = np.zeros((cap,), dtype=np.int8)
    access = np.zeros((cap,), dtype=np.int32)
    depths = np.zeros((cap,), dtype=np.int8)
    recs: list[R.Record | None] = list(all_recs)
    for i, p in enumerate(all_paths):
        hi, lo = _digest_pair(p)
        digests[i] = (hi, lo)
        toks[i] = pack_path(p, max_path_bytes)
        rec = recs[i]
        kinds[i] = 0 if isinstance(rec, R.DirRecord) else 1
        access[i] = 0 if rec is None else rec.meta.access_count
        depths[i] = P.depth(p)
    # sort rows by (hi, lo): row id == digest rank at materialize time
    order = np.lexsort((digests[:, 1], digests[:, 0]))
    digests = digests[order]
    toks[:n] = toks[order]
    kinds[:n] = kinds[order]
    access[:n] = access[order]
    depths[:n] = depths[order]
    keys_hi = np.full((cap,), KEY_SENTINEL, dtype=np.uint32)
    keys_lo = np.full((cap,), KEY_SENTINEL, dtype=np.uint32)
    keys_hi[:n] = digests[:, 0].astype(np.uint32)
    keys_lo[:n] = digests[:, 1].astype(np.uint32)
    sorted_paths = [all_paths[i] for i in order]
    sorted_recs = [recs[i] for i in order]
    row_of = {p: i for i, p in enumerate(sorted_paths)}
    # children CSR (reuses the records fetched above — no second pass)
    offsets = np.zeros((n + 1,), dtype=np.int32)
    rows: list[int] = []
    for i, p in enumerate(sorted_paths):
        rec = sorted_recs[i]
        kids: list[int] = []
        if isinstance(rec, R.DirRecord):
            for seg in rec.children():
                cp = P.child(p, seg)
                ci = row_of.get(cp)
                if ci is not None:
                    kids.append(ci)
        rows.extend(kids)
        offsets[i + 1] = len(rows)
    # lexicographic permutation over the live rows
    lex_perm = np.array(
        sorted(range(n), key=lambda i: sorted_paths[i]), dtype=np.int32)
    lex_toks = toks[lex_perm]
    # pinned hot set: "/" + dimensions == rows with depth <= 1; counted
    # straight off the depth column (no sort needed — the rows are
    # identified by depth, not by lex position)
    pinned = int(np.sum(depths[:n] <= 1))
    wiki = TensorWiki(
        keys_hi=keys_hi,
        keys_lo=keys_lo,
        path_tokens=toks,
        lex_order=lex_perm,
        lex_tokens=lex_toks,
        kinds=kinds,
        access=access,
        depths=depths,
        child_offsets=offsets,
        child_rows=np.asarray(rows, dtype=np.int32),
        n_pinned=pinned,
        paths=sorted_paths,
        n_rows=n,
        sort_perm=np.arange(n, dtype=np.int32),
        dead=np.zeros((cap,), dtype=bool),
        n_dead=0,
        child_patch={},
        row_of=row_of,
        refresh_kind="materialize",
    )
    return wiki, sorted_recs


# ---------------------------------------------------------------------------
# epoch-versioned incremental refresh
# ---------------------------------------------------------------------------
@dataclass
class TensorDelta:
    """One epoch's worth of row mutations against a ``TensorWiki``.

    ``upserts`` carries appended *and* overwritten rows (the row table is
    keyed by path, so one list covers both); ``unlinks`` lists removed
    paths.  ``epoch`` is the epoch this delta produces when applied.  The
    log of applied deltas is the device-tier analogue of the host
    invalidation stream: bounded staleness Δ = one refresh cadence.
    """

    epoch: int
    upserts: list[tuple[str, object]] = field(default_factory=list)
    unlinks: list[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.upserts) + len(self.unlinks)


@dataclass
class PatchInfo:
    """What ``apply_delta_ex`` did — the engine uses this to patch its
    device mirrors incrementally instead of re-uploading everything."""

    kind: str                   # "patch" | "rebuild"
    reason: str = ""            # why rebuild was chosen (mode="auto")
    new_rows: list[int] = field(default_factory=list)
    new_paths: list[str] = field(default_factory=list)
    removed_rows: list[int] = field(default_factory=list)
    removed_paths: list[str] = field(default_factory=list)
    overwritten_rows: list[int] = field(default_factory=list)
    keys_changed: bool = True   # digest table membership changed
    pinned_changed: bool = True # pinned (depth<=1) membership changed


def apply_delta(wiki: TensorWiki, records: list, delta: TensorDelta,
                *, mode: str = "auto") -> tuple[TensorWiki, list]:
    """Apply a ``TensorDelta`` to a snapshot, producing the next epoch's
    ``TensorWiki`` + row-aligned record table.  See ``apply_delta_ex``."""
    w, r, _ = apply_delta_ex(wiki, records, delta, mode=mode)
    return w, r


def apply_delta_ex(wiki: TensorWiki, records: list, delta: TensorDelta,
                   *, mode: str = "auto"
                   ) -> tuple[TensorWiki, list, PatchInfo]:
    """Incremental refresh: zero store round trips (contrast
    ``freeze_with_records``: full namespace scan + N point gets).

    mode="auto" patches rows in place when the delta is small and slack
    allows (O(|Δ|) host work), falling back to a full ``_materialize``
    compaction otherwise; "patch" demands the in-place path (raises if
    ineligible — benchmarks use this to isolate the two cost curves);
    "rebuild" forces the compaction path (row ids re-rank, tombstones and
    overlays fold away — byte-identical to a fresh freeze of the same
    logical table).

    The patch path consumes ``wiki``/``records`` (row tables are patched
    in place; see module docstring on ownership)."""
    ups: dict[str, object] = {}
    for p, rec in delta.upserts:
        ups[p] = rec                       # last write wins, like dict.update
    unl_eff = [p for p in dict.fromkeys(delta.unlinks)
               if p not in ups and p in wiki.row_of]
    n_new = sum(1 for p in ups if p not in wiki.row_of)
    if wiki.n - len(unl_eff) + n_new <= 0:
        # an empty TensorWiki is unrepresentable (same invariant as
        # freeze); surface the cause instead of _materialize's generic
        # "empty store" so a root-unlinking wave is debuggable
        raise ValueError(
            f"TensorDelta for epoch {delta.epoch} unlinks every resident "
            "row — refusing to commit an empty table")
    reason = "forced"
    if mode in ("auto", "patch"):
        patched, reason = _try_patch(wiki, records, delta, ups, unl_eff)
        if patched is not None:
            return patched
        if mode == "patch":
            raise ValueError(f"patch-mode refresh ineligible: {reason}")
    elif mode != "rebuild":
        raise ValueError(f"unknown apply_delta mode: {mode!r}")
    by_path: dict[str, object] = {p: records[r] for p, r in wiki.row_of.items()}
    for p in delta.unlinks:
        by_path.pop(p, None)
    for p, rec in delta.upserts:
        by_path[p] = rec
    paths = sorted(by_path)
    w2, r2 = _materialize(paths, [by_path[p] for p in paths],
                          int(wiki.path_tokens.shape[1]))
    w2 = replace(w2, refresh_kind="rebuild")
    return w2, r2, PatchInfo(kind="rebuild", reason=reason)


def _try_patch(wiki: TensorWiki, records: list, delta: TensorDelta,
               ups: dict, unl_eff: list[str]
               ) -> tuple[tuple[TensorWiki, list, PatchInfo] | None, str]:
    """In-place row patch, or (None, reason) when compaction is the right
    call.  O(|Δ|) python work + O(N) memcpy-class array moves (np.insert /
    np.delete on the int32 permutations)."""
    n_live = wiki.n
    new_paths = [p for p in ups if p not in wiki.row_of]
    n_delta = len(ups) + len(unl_eff)
    if n_delta > max(PATCH_MIN_DELTA, int(n_live * PATCH_MAX_DELTA_FRAC)):
        return None, f"delta too large ({n_delta} rows vs {n_live} live)"
    if wiki.n_rows + len(new_paths) > wiki.cap:
        return None, (f"row slack exhausted "
                      f"({wiki.n_rows}+{len(new_paths)} > cap {wiki.cap})")
    rows_after = wiki.n_rows + len(new_paths)
    if wiki.n_dead + len(unl_eff) > rows_after * PATCH_MAX_DEAD_FRAC:
        return None, (f"tombstone fraction "
                      f"({wiki.n_dead + len(unl_eff)}/{rows_after})")
    if (len(wiki.child_patch) + 2 * n_delta
            > max(PATCH_MIN_OVERLAY, n_live // 4)):
        return None, f"children overlay too large ({len(wiki.child_patch)})"

    L = int(wiki.path_tokens.shape[1])
    row_of = wiki.row_of                 # consumed: patched in place
    paths2 = list(wiki.paths)            # reader-visible: copy per epoch
    recs2 = list(records)
    keys_hi, keys_lo = wiki.keys_hi, wiki.keys_lo
    dead = wiki.dead
    touch_dirs: set[int] = set()

    def _touch_parent(p: str) -> None:
        if p == P.ROOT:
            return
        pr = row_of.get(P.parent(p))
        if pr is not None:
            touch_dirs.add(pr)

    # 1. tombstone unlinked rows (stable ids: no other row moves)
    removed_rows: list[int] = []
    for p in unl_eff:
        r = row_of.pop(p)
        dead[r] = True
        keys_hi[r] = KEY_SENTINEL
        keys_lo[r] = KEY_SENTINEL
        wiki.path_tokens[r] = 255        # unmatchable for prefix scans
        recs2[r] = None
        removed_rows.append(r)
        _touch_parent(p)
    # 2. append new rows into free slots
    new_rows: list[int] = []
    n_rows2 = wiki.n_rows
    for p in new_paths:
        r = n_rows2
        n_rows2 += 1
        hi, lo = _digest_pair(p)
        keys_hi[r] = hi
        keys_lo[r] = lo
        wiki.path_tokens[r] = pack_path(p, L)
        wiki.depths[r] = P.depth(p)
        paths2.append(p)
        recs2.append(None)               # set by the overwrite pass below
        row_of[p] = r
        new_rows.append(r)
        _touch_parent(p)
    # 3. overwrite row meta + payloads (covers new rows too)
    overwritten: list[int] = []
    child_patch2 = dict(wiki.child_patch)
    for r in removed_rows:
        child_patch2.pop(r, None)
    for p, rec in ups.items():
        r = row_of[p]
        wiki.kinds[r] = 0 if isinstance(rec, R.DirRecord) else 1
        wiki.access[r] = 0 if rec is None else rec.meta.access_count
        recs2[r] = rec
        if isinstance(rec, R.DirRecord):
            touch_dirs.add(r)
        else:
            child_patch2.pop(r, None)    # dir row overwritten by a file
        overwritten.append(r)
    # 4. recompute child lists for touched directories (parents of every
    #    appended/removed row + every upserted dir — re-admissions change
    #    a child's row id even when the parent record is byte-identical)
    for r in sorted(touch_dirs):
        if dead[r]:
            child_patch2.pop(r, None)
            continue
        rec = recs2[r]
        if not isinstance(rec, R.DirRecord):
            continue
        base = paths2[r]
        kids = [row_of[cp] for seg in rec.children()
                if (cp := P.child(base, seg)) in row_of]
        child_patch2[r] = tuple(kids)
    # 5. incremental permutation maintenance — np.delete/np.insert, not a
    #    re-sort: O(|Δ| log N) bisects + O(N) int32 moves
    lex2, sp2 = wiki.lex_order, wiki.sort_perm
    if removed_rows:
        gone = np.asarray(removed_rows, dtype=np.int32)
        lex2 = lex2[~np.isin(lex2, gone)]
        sp2 = sp2[~np.isin(sp2, gone)]
    if new_rows:
        by_lex = sorted(new_rows, key=paths2.__getitem__)
        pos_lex = [bisect.bisect_left(lex2, paths2[r],
                                      key=paths2.__getitem__)
                   for r in by_lex]
        lex2 = np.insert(lex2, pos_lex, by_lex).astype(np.int32, copy=False)

        def _key(r):
            return int(keys_hi[r]) << 32 | int(keys_lo[r])
        by_dig = sorted(new_rows, key=_key)
        pos_dig = [bisect.bisect_left(sp2, _key(r), key=_key) for r in by_dig]
        sp2 = np.insert(sp2, pos_dig, by_dig).astype(np.int32, copy=False)
    n_pinned2 = (wiki.n_pinned
                 - sum(1 for p in unl_eff if P.depth(p) <= 1)
                 + sum(1 for p in new_paths if P.depth(p) <= 1))
    info = PatchInfo(
        kind="patch",
        new_rows=new_rows,
        new_paths=new_paths,
        removed_rows=removed_rows,
        removed_paths=list(unl_eff),
        overwritten_rows=overwritten,
        keys_changed=bool(new_rows or removed_rows),
        pinned_changed=(n_pinned2 != wiki.n_pinned or any(
            P.depth(p) <= 1 for p in list(unl_eff) + new_paths)),
    )
    wiki2 = replace(
        wiki, lex_order=lex2, lex_tokens=None, sort_perm=sp2,
        paths=paths2, n_rows=n_rows2, n_dead=wiki.n_dead + len(removed_rows),
        n_pinned=n_pinned2, child_patch=child_patch2,
        refresh_kind="patch")
    return (wiki2, recs2, info), ""


def logical_state(wiki: TensorWiki, records: list) -> dict:
    """Canonical row-id-independent view of a snapshot — what patch ≡
    rebuild equivalence means (property-tested): per-path row contents +
    child lists, the lex view, the digest-sorted view, the pinned count."""
    rows = {}
    for p, r in wiki.row_of.items():
        rec = records[r]
        kids = tuple(sorted(wiki.paths[c] for c in wiki.children_of(r))) \
            if isinstance(rec, R.DirRecord) else ()
        rows[p] = (int(wiki.kinds[r]), int(wiki.access[r]),
                   int(wiki.depths[r]),
                   (int(wiki.keys_hi[r]), int(wiki.keys_lo[r])),
                   bytes(wiki.path_tokens[r]), kids, rec)
    return {
        "rows": rows,
        "lex": [wiki.paths[r] for r in wiki.lex_order],
        "digest": [wiki.paths[r] for r in wiki.sort_perm],
        "n_pinned": wiki.n_pinned,
    }


# ---------------------------------------------------------------------------
# query ops over the port's kernels (kernels.ops dispatches by device)
# ---------------------------------------------------------------------------
def batched_get(wiki: TensorWiki, query_paths: list[str],
                device: "str | torch.device | None" = None) -> np.ndarray:
    """Host convenience wrapper: paths → digests → lookup over the sorted
    live view → row ids (stable across patches)."""
    dev = resolve_device(device)
    q = np.array([_digest_pair(p) for p in query_paths], dtype=np.uint64).reshape(-1, 2)
    khi, klo, view_rows = wiki.search_view()
    keys = torch.from_numpy(ops.key64(khi, klo)).to(dev)
    qk = torch.from_numpy(ops.key64(q[:, 0], q[:, 1])).to(dev)
    pos = ops.path_lookup(keys, qk).cpu().numpy()
    hit = pos >= 0
    safe = np.clip(pos, 0, max(len(view_rows) - 1, 0))
    return np.where(hit, view_rows[safe], -1)


def search_prefix(wiki: TensorWiki, prefix: str,
                  device: "str | torch.device | None" = None) -> list[str]:
    """Prefix scan over the row-order token matrix (free slots are zeros
    and tombstones are 255s — neither can match a real prefix), results
    in lex order."""
    dev = resolve_device(device)
    p = pack_path(prefix, int(wiki.path_tokens.shape[1]))
    bitmap = ops.prefix_search(
        torch.from_numpy(np.array(wiki.path_tokens[: wiki.n_rows])).to(dev),
        torch.from_numpy(p[None, :]).to(dev),
        torch.tensor([len(prefix.encode("utf-8"))], dtype=torch.int32, device=dev))
    hits = np.nonzero(bitmap[:, 0].cpu().numpy() & wiki.live_mask())[0]
    return sorted(wiki.paths[r] for r in hits)


def contains_match_ref(lex_tokens: torch.Tensor, needle: torch.Tensor,
                       needle_len) -> torch.Tensor:
    """Keyword containment over paths (NAV's EXTRACT routing): (N, L)
    tokens x (K,) needle x its length -> (N,) bool, row r set when the
    needle's first ``needle_len`` bytes occur in the row at an offset
    where they fit.  Sliding-window equality over all rows and offsets,
    as the reference's ``contains_match_ref`` computes it; plain PyTorch
    on the tensors' device (no Pallas kernel stands behind it)."""
    N, L = lex_tokens.shape
    K = needle.shape[0]
    dev = lex_tokens.device
    n = torch.as_tensor(needle_len, dtype=torch.int32, device=dev)
    pos = (torch.arange(L, dtype=torch.int32, device=dev)[:, None]
           + torch.arange(K, dtype=torch.int32, device=dev)[None, :]).clamp(max=L - 1)
    windows = lex_tokens[:, pos]                                 # (N, L, K)
    within = torch.arange(K, dtype=torch.int32, device=dev)[None, None, :] < n
    eq = (windows == needle.to(lex_tokens.dtype)[None, None, :]) | ~within
    valid_start = torch.arange(L, dtype=torch.int32, device=dev)[None, :] + n <= L
    return (eq.all(dim=2) & valid_start).any(dim=1)


def ls_rows(wiki: TensorWiki, row: int) -> np.ndarray:
    return wiki.children_of(int(row))


def navigate_rows(wiki: TensorWiki, path: str,
                  device: "str | torch.device | None" = None) -> np.ndarray:
    """Q3 over the tensor index: one batched lookup resolves the whole
    ancestor chain at once — the step-compression idea applied to the
    storage layer itself (all D levels in one kernel launch)."""
    chain = list(P.ancestors(path)) + [path]
    return batched_get(wiki, chain, device=device)

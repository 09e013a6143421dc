"""Continuous evolution operators (paper §III-D).

* **AccessStats** — per-query co-access indicators.  The online tier is
  read-only, so NAV accumulates accessed-path sets into an in-memory log;
  the offline pipeline merges the log into (a) each record's
  ``access_count`` meta and (b) a sibling co-access sketch persisted at
  the reserved path ``/_meta/coaccess`` — keeping the paper's property
  that no external analytics warehouse is required: all statistics live
  in the same path-keyed store.

* **DIMENSIONMERGE** (Operator 1) — for sibling internal nodes v1, v2,
  estimate MI of the per-query co-access indicators (Eq. 2); when
  MI > θ_merge, merge: child list = union, access_count = sum, content =
  concatenation of summaries.

* **PAGESPLIT** (Operator 2) — Architect proposes candidates (length
  trigger or oracle adjudication of separable subtrees); Critic scores
  Δ̃C (Eq. 3) from co-located access/confidence statistics; Arbiter
  commits {e : Δ̃C<0 ∧ Safety(e)}, |C_t| ≤ K, node-disjoint.

**Theorem 1 discipline.**  The Critic's Δ̃C is an estimate; to make the
monotone-improvement guarantee *checkable* rather than assumed, the
Arbiter verifies each candidate exactly: apply → recompute C (Eq. 1) →
roll back if the measured ΔC > 0.  Estimation prunes, measurement admits.
This is strictly stronger than the paper's admissibility test and makes
the tests/test_evolution.py property (C non-increasing along the greedy
trajectory) hold by construction *and* by measurement.
"""
from __future__ import annotations

import itertools
import json
import math
from dataclasses import dataclass, field, replace

from . import paths as P
from . import records as R
from .consistency import WikiWriter
from .oracle import Oracle
from .schema import SchemaParams, schema_cost
from .store import PathStore

COACCESS_PATH = "/_meta/coaccess"


# ---------------------------------------------------------------------------
# access statistics
# ---------------------------------------------------------------------------
@dataclass
class AccessLog:
    """Per-query accessed-path sets recorded by the online tier."""

    queries: list[set[str]] = field(default_factory=list)

    def record(self, accessed: set[str]) -> None:
        self.queries.append(set(accessed))

    def __len__(self) -> int:
        return len(self.queries)


@dataclass
class CoAccessSketch:
    """n_queries, per-path marginals, sibling-pair joint counts."""

    n_queries: int = 0
    marginal: dict[str, int] = field(default_factory=dict)
    joint: dict[str, int] = field(default_factory=dict)  # "p1|p2" sorted key

    @staticmethod
    def pair_key(p1: str, p2: str) -> str:
        a, b = sorted((p1, p2))
        return f"{a}|{b}"

    def merge_log(self, log: AccessLog) -> None:
        for q in log.queries:
            self.n_queries += 1
            for p in q:
                self.marginal[p] = self.marginal.get(p, 0) + 1
            # only sibling pairs matter for DIMENSIONMERGE; cap quadratic blowup
            tops = sorted(p for p in q if P.depth(p) == 1)
            for p1, p2 in itertools.combinations(tops, 2):
                k = self.pair_key(p1, p2)
                self.joint[k] = self.joint.get(k, 0) + 1

    def mutual_information(self, p1: str, p2: str) -> float:
        """MI of the binary co-access indicators X1, X2 (paper Eq. 2)."""
        n = self.n_queries
        if n == 0:
            return 0.0
        c1 = self.marginal.get(p1, 0)
        c2 = self.marginal.get(p2, 0)
        c12 = self.joint.get(self.pair_key(p1, p2), 0)
        # joint table over {0,1}×{0,1}
        p11 = c12 / n
        p10 = max(c1 - c12, 0) / n
        p01 = max(c2 - c12, 0) / n
        p00 = max(n - c1 - c2 + c12, 0) / n
        m1 = c1 / n
        m2 = c2 / n
        mi = 0.0
        for pxy, px, py in (
            (p11, m1, m2), (p10, m1, 1 - m2),
            (p01, 1 - m1, m2), (p00, 1 - m1, 1 - m2),
        ):
            if pxy > 0 and px > 0 and py > 0:
                mi += pxy * math.log(pxy / (px * py))
        return mi

    # persistence in the same store (reserved, unadvertised).  ``store``
    # may be a PathStore or a WikiWriter — writing through the writer
    # additionally publishes the invalidation (device mirror + cache).
    def save(self, store) -> None:
        store.put_record(COACCESS_PATH, R.FileRecord(
            name="coaccess",
            text=json.dumps({"n": self.n_queries, "m": self.marginal,
                             "j": self.joint}, sort_keys=True)))

    @classmethod
    def load(cls, store: PathStore) -> "CoAccessSketch":
        rec = store.get(COACCESS_PATH)
        if rec is None or not isinstance(rec, R.FileRecord) or not rec.text:
            return cls()
        o = json.loads(rec.text)
        return cls(n_queries=o.get("n", 0), marginal=o.get("m", {}),
                   joint=o.get("j", {}))


def apply_access_log(writer: WikiWriter, log: AccessLog) -> CoAccessSketch:
    """Offline merge of the online access log into record meta + sketch."""
    counts: dict[str, int] = {}
    for q in log.queries:
        for p in q:
            counts[p] = counts.get(p, 0) + 1
    for path, c in counts.items():
        rec = writer.store.get(path)
        if rec is None:
            continue
        writer.put_record(path, replace(
            rec, meta=replace(rec.meta, access_count=rec.meta.access_count + c)))
    sketch = CoAccessSketch.load(writer.store)
    sketch.merge_log(log)
    sketch.save(writer)
    return sketch


# ---------------------------------------------------------------------------
# operator result bookkeeping
# ---------------------------------------------------------------------------
@dataclass
class OpResult:
    op: str
    target: str
    est_delta: float
    measured_delta: float
    committed: bool
    detail: str = ""


class _Snapshot:
    """Record-level undo log for exact Arbiter verification.

    ``store`` may be a ``PathStore`` or a ``WikiWriter`` (both expose
    get/put_record/delete_record); through a writer, rollback writes
    publish invalidations too — a rolled-back operator trial must reach
    the device mirror and cache just like a committed one."""

    def __init__(self, store):
        self.store = store
        self.saved: dict[str, R.Record | None] = {}

    def touch(self, path: str) -> None:
        if path not in self.saved:
            self.saved[path] = self.store.get(path)

    def rollback(self) -> None:
        for path, rec in self.saved.items():
            if rec is None:
                self.store.delete_record(path)
            else:
                self.store.put_record(path, rec)


# ---------------------------------------------------------------------------
# Operator 1: DIMENSIONMERGE
# ---------------------------------------------------------------------------
def merge_candidates(store: PathStore, sketch: CoAccessSketch,
                     params: SchemaParams) -> list[tuple[str, str, float]]:
    """Sibling dimension pairs with MI above θ_merge, highest first."""
    root = store.get(P.ROOT)
    if not isinstance(root, R.DirRecord):
        return []
    dims = [P.child(P.ROOT, s) for s in root.sub_dirs]
    out = []
    for d1, d2 in itertools.combinations(sorted(dims), 2):
        mi = sketch.mutual_information(d1, d2)
        if mi > params.theta_merge:
            out.append((d1, d2, mi))
    out.sort(key=lambda t: -t[2])
    return out


def _move_subtree(store, src: str, dst: str, snap: _Snapshot) -> None:
    """Rename src → dst by copy-then-delete, children-first writes so a
    concurrent reader never follows an advertised link to a missing record.
    ``store`` is a PathStore or WikiWriter (writer-mediated moves publish
    every touched path)."""
    rec = store.get(src)
    if rec is None:
        return
    snap.touch(dst)
    snap.touch(src)
    if isinstance(rec, R.DirRecord):
        existing = store.get(dst)
        if isinstance(existing, R.DirRecord):
            merged = existing
            for s in rec.sub_dirs:
                merged = merged.with_child(s, is_dir=True)
            for s in rec.files:
                merged = merged.with_child(s, is_dir=False)
            merged = replace(merged, summary=(existing.summary + " " + rec.summary).strip(),
                             meta=replace(merged.meta,
                                          access_count=existing.meta.access_count
                                          + rec.meta.access_count))
            store.put_record(dst, merged)
        else:
            store.put_record(dst, replace(rec, name=P.basename(dst)))
        for seg in rec.children():
            _move_subtree(store, P.child(src, seg), P.child(dst, seg), snap)
    else:
        existing = store.get(dst)
        if isinstance(existing, R.FileRecord):
            store.put_record(dst, replace(
                existing,
                text=(existing.text + "\n" + rec.text).strip(),
                meta=replace(existing.meta,
                             access_count=existing.meta.access_count
                             + rec.meta.access_count,
                             sources=sorted(set(existing.meta.sources)
                                            | set(rec.meta.sources)))))
        else:
            store.put_record(dst, replace(rec, name=P.basename(dst)))
    store.delete_record(src)


def apply_dimension_merge(writer: WikiWriter, d1: str, d2: str,
                          snap: _Snapshot) -> None:
    """Merge d2 into d1: child-list union, access sum, summary concat.
    The merged node keeps d1's segment so d1's paths stay stable; d2's
    subtree is rewritten under d1 (path-as-key means rename = rewrite)."""
    store = writer.store
    r1, r2 = store.get(d1), store.get(d2)
    if not isinstance(r1, R.DirRecord) or not isinstance(r2, R.DirRecord):
        return
    snap.touch(d1)
    snap.touch(d2)
    snap.touch(P.ROOT)
    # move children of d2 under d1 (children first); writer-mediated so
    # every rewritten path publishes an invalidation
    for seg in r2.children():
        _move_subtree(writer, P.child(d2, seg), P.child(d1, seg), snap)
    # refresh d1 record: union handled by _move_subtree linking below
    r1b = store.get(d1)
    assert isinstance(r1b, R.DirRecord)
    for seg in r2.sub_dirs:
        r1b = r1b.with_child(seg, is_dir=True)
    for seg in r2.files:
        r1b = r1b.with_child(seg, is_dir=False)
    r1b = replace(
        r1b,
        summary=(r1b.summary + " " + r2.summary).strip(),
        meta=replace(r1b.meta,
                     access_count=r1b.meta.access_count + r2.meta.access_count))
    writer.put_record(d1, r1b)
    # unlink d2 from the root, then delete its record (parent-first removal)
    root = store.get(P.ROOT)
    if isinstance(root, R.DirRecord):
        writer.put_record(P.ROOT, root.without_child(P.basename(d2)))
    writer.delete_record(d2)


# ---------------------------------------------------------------------------
# Operator 2: PAGESPLIT (Architect — Critic — Arbiter)
# ---------------------------------------------------------------------------
@dataclass
class SplitCandidate:
    path: str
    heads: list[str]
    est_delta: float = 0.0


def architect_propose(store: PathStore, oracle: Oracle,
                      params: SchemaParams) -> list[SplitCandidate]:
    """Rule-triggered proposals with the oracle as a local adjudicator:
    (i) length(e) > l_max, or (ii) the oracle finds separable subtrees."""
    out: list[SplitCandidate] = []
    for path in store.all_paths():
        if P.is_reserved(path) or P.node_type(path) != P.NODE_ENTITY:
            continue
        if P.depth(path) >= params.depth_budget - 1:
            continue  # a split would violate the depth budget — not proposable
        rec = store.get(path)
        if not isinstance(rec, R.FileRecord) or not rec.text:
            continue
        triggered = len(rec.text) > params.l_max
        heads = oracle.adjudicate_split(rec.text) if (
            triggered or len(rec.text) > params.l_max // 2) else None
        if heads and len(heads) >= 2:
            out.append(SplitCandidate(path=path, heads=heads))
    return out


def critic_score(store: PathStore, cand: SplitCandidate,
                 params: SchemaParams, total_access: int) -> float:
    """Δ̃C(e;W) = αΔ|V| + βΔ(depth·ρ) − γΔQ̃ (paper Eq. 3)."""
    rec = store.get(cand.path)
    assert isinstance(rec, R.FileRecord)
    k = len(cand.heads)
    d = P.depth(cand.path)
    rho = rec.meta.access_count / total_access if total_access else 0.0
    dV = k  # k new child pages; the hub page remains
    # post-split, the hub keeps a stub summary and the access mass lands one
    # level deeper on the specific sub-page the query wanted:
    d_depth = (d + 1) * rho - d * rho
    # quality surrogate: an over-long mixed page under-serves queries; each
    # sub-page is single-topic.  Gain ∝ access mass × (1 − confidence).
    dQ = rho * (1.0 - rec.meta.confidence) + 0.05 * rho
    return params.alpha * dV + params.beta * d_depth - params.gamma * dQ


def safety_check(store: PathStore, cand: SplitCandidate,
                 params: SchemaParams) -> bool:
    """Safety(e): every entity reachable in S_t remains reachable in S_{t+1}
    and the split respects the structural constraints."""
    if P.depth(cand.path) + 1 > params.depth_budget:
        return False
    if len(cand.heads) > params.k_max:
        return False
    rec = store.get(cand.path)
    return isinstance(rec, R.FileRecord)


def apply_page_split(writer: WikiWriter, cand: SplitCandidate,
                     snap: _Snapshot) -> None:
    """Split the entity page into per-head sub-pages under an entity hub.
    Write order: children first, then the hub directory record replaces the
    file record (parent-after-child at the sub-tree scale)."""
    store = writer.store
    rec = store.get(cand.path)
    assert isinstance(rec, R.FileRecord)
    snap.touch(cand.path)
    paras = [p for p in rec.text.split("\n\n") if p.strip()]
    buckets: dict[str, list[str]] = {h: [] for h in cand.heads}
    from .oracle import content_tokens
    for para in paras:
        ct = content_tokens(para)
        head = ct[0] if ct and ct[0] in buckets else cand.heads[0]
        buckets[head].append(para)
    per_access = rec.meta.access_count // max(len(cand.heads), 1)
    for head in cand.heads:
        sub = P.child(cand.path, head)
        snap.touch(sub)
        writer.put_record(sub, R.FileRecord(
            name=head, text="\n\n".join(buckets[head]),
            meta=replace(rec.meta, version=0, access_count=per_access,
                         confidence=min(1.0, rec.meta.confidence + 0.2))))
    hub = R.DirRecord(
        name=rec.name, files=list(cand.heads),
        summary=rec.text[:200],
        meta=R.DirMeta(updated_at=writer.clock(),
                       entry_count=len(cand.heads),
                       access_count=rec.meta.access_count))
    writer.put_record(cand.path, hub)


# ---------------------------------------------------------------------------
# one greedy evolution pass (Arbiter with exact verification)
# ---------------------------------------------------------------------------
def evolution_pass(writer: WikiWriter, oracle: Oracle, params: SchemaParams,
                   sketch: CoAccessSketch | None = None) -> list[OpResult]:
    store = writer.store
    sketch = sketch if sketch is not None else CoAccessSketch.load(store)
    results: list[OpResult] = []
    committed_supports: set[str] = set()
    before = schema_cost(store, params)
    budget = params.commit_cap

    # ---- merges (highest-MI first) ----
    for d1, d2, mi in merge_candidates(store, sketch, params):
        if budget <= 0:
            break
        if d1 in committed_supports or d2 in committed_supports:
            continue  # node-disjoint commit set (Theorem 1 requirement)
        snap = _Snapshot(writer)
        apply_dimension_merge(writer, d1, d2, snap)
        after = schema_cost(store, params)
        delta = after.total - before.total
        if delta <= 1e-9 and not after.violations:
            results.append(OpResult("merge", f"{d1}+{d2}", -mi, delta, True,
                                    detail=f"MI={mi:.4f}"))
            committed_supports.update({d1, d2})
            before = after
            budget -= 1
        else:
            snap.rollback()
            results.append(OpResult("merge", f"{d1}+{d2}", -mi, delta, False,
                                    detail=f"MI={mi:.4f} rejected"))

    # ---- splits (most-negative Δ̃C first) ----
    total_access = sum(
        (store.get(p).meta.access_count if store.get(p) is not None else 0)
        for p in store.all_paths() if not P.is_reserved(p))
    cands = architect_propose(store, oracle, params)
    for c in cands:
        c.est_delta = critic_score(store, c, params, total_access)
    cands = [c for c in cands
             if c.est_delta < 0 and safety_check(store, c, params)]
    cands.sort(key=lambda c: c.est_delta)
    for c in cands:
        if budget <= 0:
            break
        if any(P.is_prefix(s, c.path) or P.is_prefix(c.path, s)
               for s in committed_supports):
            continue
        snap = _Snapshot(writer)
        apply_page_split(writer, c, snap)
        after = schema_cost(store, params)
        delta = after.total - before.total
        if delta <= 1e-9 and not after.violations:
            results.append(OpResult("split", c.path, c.est_delta, delta, True,
                                    detail=f"heads={c.heads}"))
            committed_supports.add(c.path)
            before = after
            budget -= 1
        else:
            snap.rollback()
            results.append(OpResult("split", c.path, c.est_delta, delta, False))
    return results

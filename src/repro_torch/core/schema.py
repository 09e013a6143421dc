"""Schema design as constrained optimization (paper §III-B, Eq. 1).

    C(S;W) = α·|V| + β·Σ_v depth(v)·ρ(v) − γ·Q(S;W)

subject to depth(v) ≤ D and |children(v)| ≤ k_max.

* |V|            — size of the materialized KV namespace (storage term).
* Σ depth·ρ      — access-weighted traversal cost (online-latency term);
                   ρ is the access distribution estimated from the
                   ``access_count`` meta co-located with every record
                   (paper: "no external usage log required").
* Q(S;W)         — answer quality.  The *true* Q is end-to-end AC measured
                   by the workload (§VI); the Critic's surrogate Q̃ used
                   during evolution is the access-weighted confidence of
                   file records (paper Eq. 3).

The greedy local search of §III-D applies node-disjoint admissible
operators; Theorem 1 (monotone improvement) is property-tested in
tests/test_evolution.py against this exact cost function.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import paths as P
from . import records as R
from .store import PathStore


@dataclass(frozen=True)
class SchemaParams:
    """Deployment-time hyperparameters of Eq. 1 + structural constraints."""

    alpha: float = 1.0
    beta: float = 4.0
    gamma: float = 8.0
    depth_budget: int = P.DEFAULT_DEPTH_BUDGET
    k_max: int = 64           # per-node fan-out bound
    l_max: int = 4000         # PageSplit length trigger (chars)
    theta_merge: float = 0.08  # DimensionMerge MI threshold
    commit_cap: int = 4        # K: per-pass commit count cap


@dataclass
class CostBreakdown:
    storage: float = 0.0       # α|V|
    descent: float = 0.0       # βΣ depth·ρ
    quality: float = 0.0       # γQ̃
    n_nodes: int = 0
    violations: list[str] = field(default_factory=list)

    @property
    def total(self) -> float:
        return self.storage + self.descent - self.quality


def access_distribution(store: PathStore,
                        skip_sources: bool = True) -> dict[str, float]:
    """ρ(v) from co-located access_count meta; uniform fallback when the
    wiki has never been queried."""
    counts: dict[str, int] = {}
    for path in store.all_paths():
        if skip_sources and P.is_reserved(path):
            continue
        rec = store.get(path)
        if rec is None:
            continue
        counts[path] = rec.meta.access_count
    total = sum(counts.values())
    if total == 0:
        n = max(len(counts), 1)
        return {p: 1.0 / n for p in counts}
    return {p: c / total for p, c in counts.items()}


def quality_surrogate(store: PathStore, rho: dict[str, float]) -> float:
    """Q̃: access-weighted mean confidence over file records (Critic, Eq. 3)."""
    num = den = 0.0
    for path, w in rho.items():
        rec = store.get(path)
        if isinstance(rec, R.FileRecord):
            num += w * rec.meta.confidence
            den += w
    return num / den if den > 0 else 0.0


def schema_cost(store: PathStore, params: SchemaParams,
                quality: float | None = None) -> CostBreakdown:
    """Evaluate Eq. 1 over the materialized wiki (sources subtree excluded —
    it is hoisted shared storage, not schema shape; §IV-A)."""
    rho = access_distribution(store)
    n_nodes = 0
    descent = 0.0
    violations: list[str] = []
    for path in store.all_paths():
        if P.is_reserved(path):
            continue
        n_nodes += 1
        d = P.depth(path)
        if d > params.depth_budget:
            violations.append(f"depth({path})={d} > D={params.depth_budget}")
        descent += d * rho.get(path, 0.0)
        rec = store.get(path)
        if isinstance(rec, R.DirRecord):
            fan = len(rec.children())
            if fan > params.k_max:
                violations.append(f"fanout({path})={fan} > k_max={params.k_max}")
    q = quality if quality is not None else quality_surrogate(store, rho)
    return CostBreakdown(
        storage=params.alpha * n_nodes,
        descent=params.beta * descent,
        quality=params.gamma * q,
        n_nodes=n_nodes,
        violations=violations,
    )


def structure_counts(store: PathStore) -> dict[str, int]:
    """Directory/page/source counts (the Fig. 5(a) quantities)."""
    dirs = pages = digests = docs = 0
    for path in store.all_paths():
        if P.is_prefix(P.META_PREFIX, path):
            continue
        t = P.node_type(path)
        rec = store.get(path)
        if rec is None:
            continue
        if t == P.NODE_DIGEST:
            digests += 1
        elif t == P.NODE_DOCUMENT:
            docs += 1
        elif isinstance(rec, R.DirRecord):
            dirs += 1
        else:
            pages += 1
    return {"directories": dirs, "pages": pages,
            "digests": digests, "documents": docs}

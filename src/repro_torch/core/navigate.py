"""Budgeted path navigation NAV(q, B) (paper §V, Algorithm 1).

Two-phase, search-accelerated plan:
  Phase 1 — CLASSIFY(q) routes enumeration queries straight to LS("/");
            everything else runs SEARCH(EXTRACT(q)) over the path namespace
            for k candidate paths (constant KV round trips, independent of
            depth D).
  Phase 2 — targeted GETs on candidates; NEEDSDEEPER triggers at most one
            single-level LS expansion per candidate.

Progressive-answer contract (Property 1): results are emitted in order of
monotonically increasing granularity — r1 index summary, r2 dimension
summary, then entity/source pages — so *any* prefix of the output is a
valid (coarser) answer.  Budget guards run before every potentially
expensive step; on exhaustion the accumulated prefix is returned as-is.

Budgets are pluggable: ``WallClockBudget`` (production semantics, ms) or
``UnitBudget`` (deterministic virtual costs for tests — DESIGN.md §3).

Theorem 3 (step compression) is observable via ``NavTrace.llm_calls``:
layer-by-layer navigation needs D oracle descents; here a single SEARCH
replaces the first D−h levels, leaving h ∈ {0, 1} NEEDSDEEPER calls per
single-target query (≤ k when q aggregates across k dimensions).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Generator, Optional

from . import paths as P
from . import records as R
from .cache import TieredCache
from .engine import BatchPlanner, HostEngine, QueryEngine, drive
from .oracle import (ROUTE_AGGREGATE, ROUTE_ENUMERATE, ROUTE_LOOKUP, Oracle)
from .store import PathStore

# result granularity levels, in emission order (Property 1)
KIND_INDEX = "index_summary"
KIND_DIMENSION = "dimension_summary"
KIND_ENTITY = "entity_page"
KIND_LISTING = "listing"
KIND_SOURCE = "source"

# paper §V-A: r1 = index level, r2 = dimension level, r3.. = entity OR
# article level — one shared granularity bucket from r3 onward.
_GRANULARITY = {KIND_INDEX: 0, KIND_DIMENSION: 1, KIND_ENTITY: 2,
                KIND_LISTING: 2, KIND_SOURCE: 2}


@dataclass
class NavResult:
    kind: str
    path: str
    text: str

    @property
    def granularity(self) -> int:
        return _GRANULARITY[self.kind]


@dataclass
class NavTrace:
    """Per-query accounting (Tables III/V/VI metrics)."""

    tool_calls: int = 0     # GET/LS/SEARCH storage operations
    pages_read: int = 0     # entity/source payloads read
    llm_calls: int = 0      # oracle descents on the critical path
    accessed: set[str] = field(default_factory=set)
    budget_exhausted: bool = False
    route: str = ""
    rounds: int = 0         # planner rounds this session stayed live
                            # (set by run_sessions; 0 for unbatched nav)


class Budget:
    def charge(self, op: str) -> None:
        raise NotImplementedError

    def exhausted(self) -> bool:
        raise NotImplementedError


class WallClockBudget(Budget):
    """B in milliseconds of wall-clock (production semantics)."""

    def __init__(self, ms: float, clock: Callable[[], float] = time.monotonic):
        self.t0 = clock()
        self.ms = ms
        self.clock = clock

    def charge(self, op: str) -> None:
        pass

    def exhausted(self) -> bool:
        return (self.clock() - self.t0) * 1000.0 >= self.ms


class UnitBudget(Budget):
    """Deterministic virtual-cost budget; op costs mirror the paper's
    dominant-step analysis (LLM call ≫ storage round trip)."""

    COSTS = {"get": 1, "ls": 1, "search": 2, "classify": 1, "llm": 25}

    def __init__(self, units: int):
        self.units = units
        self.spent = 0

    def charge(self, op: str) -> None:
        self.spent += self.COSTS.get(op, 1)

    def exhausted(self) -> bool:
        return self.spent >= self.units


#: generator type of one navigation session: yields whenever it has
#: enqueued planner futures that need a flush; returns (results, trace)
NavSession = Generator[None, None, "tuple[list[NavResult], NavTrace]"]


class Navigator:
    """NAV(q, B), expressed as operation futures against a BatchPlanner.

    Accepts a ``PathStore``/``ShardedPathStore`` (wrapped in a
    ``HostEngine``), a ``QueryEngine`` (host or device), or an existing
    ``BatchPlanner`` (shared with other components, e.g. the serving
    engine).  Each query is a *session generator* that yields at every
    point it needs storage results; the planner batches the pending
    operations of every in-flight session into one engine call per
    operator.  ``nav()`` drives a single session (flush per yield);
    ``nav_many()`` schedules many sessions concurrently — that is where
    the batching wins come from.
    """

    def __init__(self, store, oracle: Oracle,
                 cache: TieredCache | None = None, k: int = 3,
                 theta: float = 0.34, search_routing: bool = True):
        if isinstance(store, BatchPlanner):
            self.planner = store
            self.engine = store.engine
        elif isinstance(store, QueryEngine):
            self.engine = store
            self.planner = BatchPlanner(store)
        else:
            self.engine = HostEngine(store)
            self.planner = BatchPlanner(self.engine)
        # host-side store handle when one exists (back-compat / ablation)
        self.store = getattr(self.engine, "store", None)
        self.oracle = oracle
        self.cache = cache
        self.k = k
        self.theta = theta
        self.search_routing = search_routing

    # -- storage primitives as planner futures -----------------------------
    # each helper charges the budget/trace exactly where the direct-call
    # implementation did, then yields once if (and only if) it actually
    # needs a planner flush — cache hits resolve without yielding.
    def _get_g(self, path: str, trace: NavTrace, budget: Budget):
        budget.charge("get")
        trace.tool_calls += 1
        trace.accessed.add(path)
        if self.cache is not None:
            hit = self.cache.peek(path)
            if hit is not None:
                return hit
        fut = self.planner.get(path)
        yield
        rec = fut.value
        if self.cache is not None:
            self.cache.admit(path, rec)
        return rec

    def _get_many_g(self, paths: list[str], trace: NavTrace, budget: Budget):
        """Batch variant for independent point reads (charges first, one
        yield for the whole set)."""
        for p in paths:
            budget.charge("get")
            trace.tool_calls += 1
            trace.accessed.add(p)
        resolved: dict[str, Optional[R.Record]] = {}
        futs = []
        for p in paths:
            if self.cache is not None:
                hit = self.cache.peek(p)
                if hit is not None:
                    resolved[p] = hit
                    continue
            futs.append((p, self.planner.get(p)))
        if futs:
            yield
        for p, fut in futs:
            rec = fut.value
            if self.cache is not None:
                self.cache.admit(p, rec)
            resolved[p] = rec
        return [resolved[p] for p in paths]

    def _ls_g(self, path: str, trace: NavTrace, budget: Budget):
        budget.charge("ls")
        trace.tool_calls += 1
        trace.accessed.add(path)
        if self.cache is not None:
            # mirror TieredCache.ls: fetch the RECORD (so file records are
            # promoted too — a later _get_g on the same path is a cache
            # hit), derive the child listing locally
            rec = self.cache.peek(path)
            if rec is None:
                fut = self.planner.get(path)
                yield
                rec = fut.value
                self.cache.admit(path, rec)
            if not isinstance(rec, R.DirRecord):
                return None
            return rec, [P.child(path, s) for s in rec.children()]
        fut = self.planner.ls(path)
        yield
        return fut.value

    # ----------------------------------------------------------------------
    def nav(self, q: str, budget: Budget) -> tuple[list[NavResult], NavTrace]:
        """Single-query entry point: drives one session, flushing the
        planner at every yield (batch size ≥ 1)."""
        return drive(self.session(q, budget), self.planner)

    def nav_many(self, queries: list[str], budgets: list[Budget]
                 ) -> list[tuple[list[NavResult], NavTrace]]:
        """Run many sessions concurrently: every round advances each live
        session to its next storage dependency, then ONE planner flush
        executes the union of their pending ops as per-operator batches."""
        gens = [self.session(q, b) for q, b in zip(queries, budgets)]
        return run_sessions(self.planner, gens)

    def session(self, q: str, budget: Budget) -> NavSession:
        trace = NavTrace()
        R_out: list[NavResult] = []

        budget.charge("classify")
        cls = self.oracle.classify_query(q)
        trace.route = cls

        # r1: index-level summary — the coarsest valid answer, from L1.
        root_ls = yield from self._ls_g(P.ROOT, trace, budget)
        if root_ls is not None:
            rec, children = root_ls
            dims = [P.basename(c) for c in children if not P.is_reserved(c)]
            R_out.append(NavResult(
                KIND_INDEX, P.ROOT,
                f"the wiki contains {len(dims)} dimensions: " + ", ".join(dims)))

        # enumeration queries: answered by the single directory listing
        if cls == ROUTE_ENUMERATE:
            return R_out, trace

        # Phase 1: search-accelerated routing
        if self.search_routing:
            budget.charge("search")
            trace.tool_calls += 1
            keywords = self.oracle.extract_keywords(q)
            candidates = yield from self._search_candidates_g(keywords)
        else:
            # ablation: pure layer-by-layer navigation (w/o Search Routing)
            candidates = yield from self._layer_by_layer_g(q, trace, budget)

        if budget.exhausted():
            trace.budget_exhausted = True
            return R_out, trace  # coarsest fallback prefix

        # Phase 2: targeted navigation.
        # r2 first: dimension summaries for all candidate dimensions, so the
        # emission order stays monotone in granularity (Property 1).  The
        # dimension reads are independent → one batched round.
        chosen = candidates[: self.k if self.search_routing else None]
        dims_wanted: list[str] = []
        emitted_dims: set[str] = set()
        for path in chosen:
            segs = P.segments(path)
            if not segs or P.is_reserved(path):
                continue
            dim = P.SEP + segs[0]
            if dim in emitted_dims:
                continue
            emitted_dims.add(dim)
            dims_wanted.append(dim)
        dim_recs = yield from self._get_many_g(dims_wanted, trace, budget)
        for dim, drec in zip(dims_wanted, dim_recs):
            if isinstance(drec, R.DirRecord):
                R_out.append(NavResult(
                    KIND_DIMENSION, dim,
                    f"{P.basename(dim)} contains {len(drec.children())} "
                    f"entries: " + ", ".join(drec.children()[:12])))
        # r3 onward: entity/article pages
        for path in chosen:
            rec = yield from self._get_g(path, trace, budget)
            if rec is None:
                continue  # skip-on-miss
            # the candidate page itself
            text = rec.text if isinstance(rec, R.FileRecord) else rec.summary
            kind = KIND_SOURCE if P.is_prefix(P.SOURCES_PREFIX, path) else KIND_ENTITY
            R_out.append(NavResult(kind, path, text))
            trace.pages_read += 1
            # linked sources: follow entity-page links to the hoisted subtree
            if isinstance(rec, R.FileRecord):
                for src in rec.meta.sources[:2]:
                    if budget.exhausted():
                        break
                    srec = yield from self._get_g(src, trace, budget)
                    if isinstance(srec, R.FileRecord):
                        R_out.append(NavResult(KIND_SOURCE, src, srec.text))
                        trace.pages_read += 1
            # NEEDSDEEPER: at most one single-level expansion
            budget.charge("llm")
            trace.llm_calls += 1
            if self.oracle.needs_deeper(q, text, self.theta):
                deeper = yield from self._ls_g(path, trace, budget)
                if deeper is not None:
                    drec, kids = deeper
                    R_out.append(NavResult(
                        KIND_LISTING, path,
                        "contains: " + ", ".join(P.basename(kp) for kp in kids)))
                    for kp in kids[:2]:
                        if budget.exhausted():
                            break
                        krec = yield from self._get_g(kp, trace, budget)
                        if isinstance(krec, R.FileRecord):
                            R_out.append(NavResult(KIND_ENTITY, kp, krec.text))
                            trace.pages_read += 1
            if budget.exhausted():
                trace.budget_exhausted = True
                break
        return R_out, trace

    # ----------------------------------------------------------------------
    def _search_candidates_g(self, keywords: list[str]):
        """SEARCH(EXTRACT(q)): keyword routing over the path namespace —
        all keywords resolve in one batched containment round.  Scores
        paths by keyword hits; prefers deeper (more specific) pages."""
        futs = [(kw, self.planner.contains(kw, limit=64)) for kw in keywords]
        if futs:
            yield
        scores: dict[str, float] = {}
        for kw, fut in futs:
            for p in fut.value:
                if P.is_prefix(P.META_PREFIX, p):
                    continue
                scores[p] = scores.get(p, 0.0) + 1.0 + 0.1 * P.depth(p)
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return [p for p, _ in ranked[: self.k * 3]]

    def _layer_by_layer_g(self, q: str, trace: NavTrace, budget: Budget):
        """Ablation path: descend one oracle call per level from the root
        (the D-step plan Theorem 3 compresses away)."""
        frontier = [P.ROOT]
        found: list[str] = []
        qk = set(self.oracle.extract_keywords(q))
        while frontier and not budget.exhausted():
            path = frontier.pop(0)
            out = yield from self._ls_g(path, trace, budget)
            if out is None:
                rec = yield from self._get_g(path, trace, budget)
                if rec is not None:
                    found.append(path)
                continue
            _, children = out
            # one LLM adjudication per level: pick children lexically
            # overlapping the query
            budget.charge("llm")
            trace.llm_calls += 1
            picked = [c for c in children
                      if not P.is_reserved(c)
                      and (set(P.basename(c).lower().split("_")) & qk
                           or any(k in P.basename(c).lower() for k in qk))]
            if not picked:
                picked = [c for c in children if not P.is_reserved(c)][:2]
            frontier.extend(picked[:3])
            # probe reads (uncharged in the direct-call implementation):
            # batch them in one round
            futs = [(c, self.planner.get(c)) for c in picked]
            if futs:
                yield
            for c, fut in futs:
                if fut.value is not None and P.depth(c) >= 2:
                    found.append(c)
        return found


def run_sessions(planner: BatchPlanner, gens: list[NavSession]
                 ) -> list[tuple[list[NavResult], NavTrace]]:
    """Concurrent session scheduler: round-based continuous batching of
    storage operations.  Each round advances every live session once,
    then a single ``planner.flush()`` executes all pending operations as
    per-operator batches."""
    out: list = [None] * len(gens)
    rounds = [0] * len(gens)
    active = list(enumerate(gens))
    while active:
        still = []
        for i, g in active:
            rounds[i] += 1
            try:
                next(g)
                still.append((i, g))
            except StopIteration as e:
                out[i] = e.value
        planner.flush()
        active = still
    # one wave == one run_sessions call: writes admitted during the wave
    # (writer sessions sharing this planner) commit to the read view here,
    # so the NEXT wave pins the fresh epoch — staleness Δ = 1 wave
    planner.engine.refresh()
    for i, res in enumerate(out):
        if res is not None:
            res[1].rounds = rounds[i]
    return out


def check_progressive(results: list[NavResult]) -> bool:
    """Property 1: granularity is monotonically non-decreasing, so every
    prefix is itself a usable (coarser) answer."""
    levels = [r.granularity for r in results]
    return all(a <= b for a, b in zip(levels, levels[1:]))

"""Cold-start: Intent-Anchored Schema Induction (paper §III-C).

IASI runs once at deployment time, off the critical path:

  1. **Ingestion filter Φ** removes seven categories of low-information
     documents *before* sampling, so the positioning descriptor 𝒫 is not
     miscalibrated at the source.
  2. A fixed-size sample 𝒮 ⊂ 𝒟 (independent of |𝒟|) feeds the oracle.
  3. The oracle emits the corpus positioning descriptor
     𝒫 = ⟨focus, audience, ingestion-bias⟩.
  4. The oracle emits the directory scaffold T fixing V_I, V_D, V_E and the
     parent-child structure at those levels, with the §III-B structural
     constraints enforced *by construction* (no generate-then-validate loop).

𝒫 is a first-class schema object: it is materialized to durable storage at
the reserved (unadvertised) path ``/_meta/positioning`` and read directly by
the evolution operators.
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass

from . import paths as P
from . import records as R
from .consistency import WikiWriter
from .oracle import Oracle, ScaffoldSpec
from .schema import SchemaParams

POSITIONING_PATH = "/_meta/positioning"

# ---------------------------------------------------------------------------
# Ingestion filter Φ — seven low-information categories (paper §III-C).
# ---------------------------------------------------------------------------
_GREETING_RE = re.compile(
    r"\b(happy\s+(new\s+year|holidays|spring\s+festival)|season'?s\s+greetings|"
    r"merry\s+christmas|best\s+wishes\s+for)\b", re.I)
_ANNOUNCE_RE = re.compile(
    r"\b(announcing|announcement|save\s+the\s+date|event\s+notice|"
    r"will\s+be\s+held|registration\s+opens)\b", re.I)
_AD_RE = re.compile(
    r"\b(limited\s+time\s+offer|discount|coupon|buy\s+now|sponsored)\b", re.I)
_LINKFARM_RE = re.compile(r"(https?://\S+\s*){3,}")

FILTER_CATEGORIES = (
    "seasonal_greeting",      # boilerplate seasonal greetings
    "republication",          # verbatim re-publication of upstream content
    "event_announcement",     # event announcements
    "advertisement",          # promotional content
    "link_farm",              # documents that are mostly links
    "too_short",              # trivially short content
    "template_boilerplate",   # repeated template text across docs
)


@dataclass
class FilterReport:
    kept: list[dict]
    dropped: dict[str, list[str]]  # category -> doc ids

    @property
    def drop_count(self) -> int:
        return sum(len(v) for v in self.dropped.values())


def ingestion_filter(docs: list[dict], min_chars: int = 80) -> FilterReport:
    """Φ: drop the seven low-information categories before sampling."""
    kept: list[dict] = []
    dropped: dict[str, list[str]] = {c: [] for c in FILTER_CATEGORIES}
    seen_hashes: dict[str, str] = {}
    body_counts: dict[str, int] = {}
    for d in docs:
        body_counts[_template_key(d["text"])] = \
            body_counts.get(_template_key(d["text"]), 0) + 1
    for d in docs:
        text, did = d["text"], d.get("id", d.get("title", "?"))
        h = hashlib.sha1(text.strip().encode()).hexdigest()
        cat = None
        if h in seen_hashes:
            cat = "republication"
        elif len(text.strip()) < min_chars:
            cat = "too_short"
        elif _GREETING_RE.search(text):
            cat = "seasonal_greeting"
        elif _ANNOUNCE_RE.search(text):
            cat = "event_announcement"
        elif _AD_RE.search(text):
            cat = "advertisement"
        elif _LINKFARM_RE.search(text):
            cat = "link_farm"
        elif body_counts[_template_key(text)] >= 4:
            cat = "template_boilerplate"
        if cat is None:
            seen_hashes[h] = did
            kept.append(d)
        else:
            dropped[cat].append(did)
    return FilterReport(kept=kept, dropped=dropped)


def _template_key(text: str) -> str:
    """First 60 chars with digits masked — detects repeated templates."""
    return re.sub(r"\d+", "#", text.strip()[:60])


def sample_corpus(docs: list[dict], sample_size: int, seed: int = 0) -> list[dict]:
    """Deterministic fixed-size sample, independent of |𝒟| (paper §III-C).
    Uses a content-hash order so the sample is stable under corpus append."""
    ranked = sorted(
        docs,
        key=lambda d: hashlib.sha1(
            (str(seed) + d.get("id", d.get("title", ""))).encode()).hexdigest())
    return ranked[:sample_size]


@dataclass
class ColdStartResult:
    scaffold: ScaffoldSpec
    positioning: dict[str, str]
    filter_report: FilterReport
    n_dimensions: int
    n_entities: int


def cold_start(writer: WikiWriter, corpus: list[dict], oracle: Oracle,
               params: SchemaParams, sample_size: int = 24,
               seed: int = 0) -> ColdStartResult:
    """Run IASI and materialize S₀ into the store."""
    report = ingestion_filter(corpus)
    sample = sample_corpus(report.kept, sample_size, seed=seed)
    pos = oracle.positioning(sample)
    scaffold = oracle.induce_scaffold(
        sample, pos, k_max=params.k_max, depth_budget=params.depth_budget)

    # materialize: root, dimensions, entity pages (empty leaves at cold start)
    writer.ensure_root(summary=f"Knowledge base — focus: {pos.get('focus','')}")
    n_ent = 0
    for dim, ents in scaffold.dimensions.items():
        dpath = P.child(P.ROOT, dim)
        writer.admit(dpath, R.DirRecord(
            name=dim, summary=f"Dimension: {dim}",
            meta=R.DirMeta(updated_at=writer.clock())))
        for ent in ents[: params.k_max]:
            epath = P.child(dpath, ent)
            writer.admit(epath, R.FileRecord(
                name=ent, text="",
                meta=R.FileMeta(version=0, confidence=0.5,
                                last_verified=writer.clock())))
            n_ent += 1

    # 𝒫 is a durable first-class object, deliberately *unadvertised*
    # (not linked into any directory listing) so it never appears in NAV
    # results but is directly addressable by the evolution operators.
    writer.store.put_record(POSITIONING_PATH, R.FileRecord(
        name="positioning", text=json.dumps(pos, sort_keys=True),
        meta=R.FileMeta(version=0, confidence=1.0)))
    return ColdStartResult(
        scaffold=scaffold, positioning=pos, filter_report=report,
        n_dimensions=len(scaffold.dimensions), n_entities=n_ent)


def load_positioning(store) -> dict[str, str] | None:
    rec = store.get(POSITIONING_PATH)
    if rec is None or not isinstance(rec, R.FileRecord):
        return None
    return json.loads(rec.text)

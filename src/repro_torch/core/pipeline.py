"""Offline construction-and-evolution pipeline (paper §III-E).

Cadences: cold-start is one-shot; DIMENSIONMERGE + PAGESPLIT run every N
ingested articles (N=30 in the deployment); the Error Book's deterministic
pass runs after every batch, its oracle pass periodically.  Multi-process
parallel construction partitions by author subtree (§IV-C): each author's
corpus compiles into its own store/writer — per-author-parallel,
intra-author-serial — so Theorem 2 holds per subtree with no cross-author
coordination.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from . import paths as P
from . import records as R
from .coldstart import ColdStartResult, cold_start
from .consistency import InvalidationBus, WikiWriter
from .errorbook import ErrorBook, run_errorbook
from .evolution import (AccessLog, CoAccessSketch, apply_access_log,
                        evolution_pass)
from .oracle import Oracle, ScaffoldSpec
from .schema import SchemaParams
from .store import MemKV, PathStore


@dataclass
class PipelineConfig:
    params: SchemaParams = field(default_factory=SchemaParams)
    evolution_every_n: int = 30   # N articles between evolution passes
    llm_errorbook_every: int = 4  # batches between oracle-level EB passes
    sample_size: int = 24
    seed: int = 0
    enable_coldstart: bool = True
    enable_evolution: bool = True
    fixed_dimensions: list[str] | None = None  # Table III "FIXED" variant


@dataclass
class IngestStats:
    ingested: int = 0
    digests: int = 0
    entity_updates: int = 0
    skipped: int = 0
    evolution_ops: int = 0
    errorbook_errors: int = 0


class ConstructionPipeline:
    """One author's construction-and-evolution pipeline over one subtree."""

    def __init__(self, cfg: PipelineConfig, oracle: Oracle,
                 store: PathStore | None = None,
                 bus: InvalidationBus | None = None):
        self.cfg = cfg
        self.oracle = oracle
        self.store = store if store is not None else PathStore(MemKV())
        self.bus = bus if bus is not None else InvalidationBus()
        self.writer = WikiWriter(self.store, bus=self.bus)
        self.scaffold: ScaffoldSpec | None = None
        self.stats = IngestStats()
        self._since_evolution = 0
        self._batch_no = 0

    # ------------------------------------------------------------------
    def bootstrap(self, corpus: list[dict]) -> ColdStartResult | None:
        """Cold-start (IASI) or the FIXED-schema baseline of Table III."""
        if self.cfg.fixed_dimensions is not None:
            self.writer.ensure_root(summary="fixed-schema wiki")
            dims = {}
            for dim in self.cfg.fixed_dimensions:
                self.writer.admit(P.child(P.ROOT, dim), R.DirRecord(
                    name=dim, summary=f"Dimension: {dim}"))
                dims[dim] = []
            self.scaffold = ScaffoldSpec(dimensions=dims, positioning={})
            return None
        if not self.cfg.enable_coldstart:
            # w/o Cold-Start ablation (Table VI): full-document injection
            result = cold_start(self.writer, corpus, self.oracle,
                                self.cfg.params,
                                sample_size=len(corpus), seed=self.cfg.seed)
        else:
            result = cold_start(self.writer, corpus, self.oracle,
                                self.cfg.params,
                                sample_size=self.cfg.sample_size,
                                seed=self.cfg.seed)
        self.scaffold = result.scaffold
        return result

    # ------------------------------------------------------------------
    def ingest(self, docs: list[dict]) -> IngestStats:
        """One ingestion batch: digest + article records into the hoisted
        /sources subtree, entity pages updated with links — all via the
        parent-after-child writer.  The ingestion filter Φ runs here too
        (low-information docs never enter the wiki, matching the
        ingestion-bias recorded in 𝒫)."""
        assert self.scaffold is not None, "bootstrap() first"
        from .coldstart import ingestion_filter
        report = ingestion_filter(docs)
        self.stats.skipped += report.drop_count
        docs = report.kept
        book = ErrorBook.load(self.store)
        banned_links = set(book.bad_link_targets)
        for doc in docs:
            title = doc.get("title") or doc.get("id") or "untitled"
            art_path = P.article_path(title)
            dig_path = P.digest_path(title)
            if self.store.get(art_path) is not None:
                self.stats.skipped += 1
                continue
            # sources first (they are link targets)
            self.writer.admit(art_path, R.FileRecord(
                name=P.basename(art_path), text=doc["text"],
                meta=R.FileMeta(version=0, confidence=1.0,
                                last_verified=self.writer.clock())))
            digest = self.oracle.summarize([doc["text"]], limit=300)
            self.writer.admit(dig_path, R.FileRecord(
                name=P.basename(dig_path), text=digest,
                meta=R.FileMeta(version=0, confidence=0.9,
                                sources=[art_path],
                                last_verified=self.writer.clock())))
            self.stats.digests += 1
            # entity assignment + page update (links, not copies — §IV-A)
            for dim, ent in self.oracle.assign_entities(doc, self.scaffold):
                dpath = P.child(P.ROOT, dim)
                if self.store.get(dpath) is None:
                    if self.cfg.fixed_dimensions is not None:
                        dim = self.cfg.fixed_dimensions[0]
                        dpath = P.child(P.ROOT, dim)
                    else:
                        self.writer.admit(dpath, R.DirRecord(
                            name=dim, summary=f"Dimension: {dim}"))
                epath = P.child(dpath, ent)
                if dig_path in banned_links:
                    continue  # Error Book constraint: known-bad target
                self._update_entity(epath, ent, doc, dig_path, art_path)
                self.stats.entity_updates += 1
            self.stats.ingested += 1
            self._since_evolution += 1
        # Error Book deterministic pass after every batch
        self._batch_no += 1
        with_llm = (self._batch_no % self.cfg.llm_errorbook_every == 0)
        book, report = run_errorbook(self.writer, self.oracle,
                                     with_llm_pass=with_llm)
        self.stats.errorbook_errors += report.total
        # evolution every N articles
        if (self.cfg.enable_evolution
                and self._since_evolution >= self.cfg.evolution_every_n):
            ops = evolution_pass(self.writer, self.oracle, self.cfg.params)
            self.stats.evolution_ops += sum(1 for o in ops if o.committed)
            self._since_evolution = 0
        # LSM hygiene between offline batches: flush + compact so the
        # online read path sees one sorted run (store-level so the durable
        # and sharded facades fan out per engine/shard)
        self.store.flush()
        self.store.compact()
        return self.stats

    def _update_entity(self, epath: str, ent: str, doc: dict,
                       dig_path: str, art_path: str) -> None:
        rec = self.store.get(epath)
        # entity-relevant digest: the sentences of the document that
        # mention this entity (that is what an entity page *is*), plus
        # the structured fact lines — then the wikilink to the source
        ent_words = set(ent.lower().split("_"))
        relevant = [s for s in doc["text"].split(". ")
                    if ent_words & set(s.lower().replace(":", " ").split())]
        summary_line = self.oracle.summarize(
            relevant or [doc["text"]], limit=600)
        fact_lines = "\n".join(doc.get("facts", []))
        addition = (f"{summary_line}\n{fact_lines}\n"
                    f"[[{dig_path}]]").strip()
        if rec is None:
            self.writer.admit(epath, R.FileRecord(
                name=ent, text=addition,
                meta=R.FileMeta(version=0, confidence=0.8,
                                sources=[dig_path, art_path],
                                last_verified=self.writer.clock())))
        elif isinstance(rec, R.FileRecord):
            def _mut(r: R.FileRecord) -> R.FileRecord:
                text = (r.text + "\n\n" + addition).strip()
                srcs = sorted(set(r.meta.sources) | {dig_path, art_path})
                return replace(r, text=text, meta=replace(
                    r.meta, sources=srcs, confidence=min(1.0, r.meta.confidence + 0.05),
                    last_verified=self.writer.clock()))
            self.writer.update_file(epath, _mut)
        else:
            # entity was split into a hub — descend to the matching sub-page
            sub = P.child(epath, ent)
            if self.store.get(sub) is None and P.depth(sub) <= self.cfg.params.depth_budget:
                self.writer.admit(sub, R.FileRecord(
                    name=ent, text=addition,
                    meta=R.FileMeta(version=0, confidence=0.8,
                                    sources=[dig_path, art_path])))

    # ------------------------------------------------------------------
    def absorb_access_log(self, log: AccessLog) -> CoAccessSketch:
        return apply_access_log(self.writer, log)

    def run_evolution(self) -> list:
        return evolution_pass(self.writer, self.oracle, self.cfg.params)


def build_author_wikis(corpora: dict[str, list[dict]], oracle_factory,
                       cfg: PipelineConfig,
                       batch_size: int = 16) -> dict[str, ConstructionPipeline]:
    """Per-author-parallel construction (paper §IV-C): author subtrees are
    disjoint by construction, so building them in any order — or on a pool
    of workers — introduces no write-write conflicts.  Serial here; the
    distributed launcher shards authors over the data axis."""
    out: dict[str, ConstructionPipeline] = {}
    for author, corpus in sorted(corpora.items()):
        pipe = ConstructionPipeline(cfg, oracle_factory())
        pipe.bootstrap(corpus)
        for i in range(0, len(corpus), batch_size):
            pipe.ingest(corpus[i:i + batch_size])
        out[author] = pipe
    return out

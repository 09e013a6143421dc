"""Content-level self-correction: the Error Book (paper §III-D/§III-E).

While DIMENSIONMERGE / PAGESPLIT act on the structural shape of the
namespace, the Error Book acts on individual record contents.  Detected
error patterns accumulate as *constraint rules* that are (a) injected into
subsequent ingestion (the ingestor consults them to avoid re-introducing
known errors) and (b) repaired by a two-layer loop: deterministic
code-level fixes after every batch, plus a periodic oracle-based fix.

State is persisted at the reserved path ``/_meta/errorbook`` — the same
path-keyed records as everything else — so constraints accumulated in
earlier full/incremental runs keep taking effect in later ones (the
re-grounding this paper contributes).

Error patterns detected:
  * dangling_wikilink      — ``[[/path]]`` links whose target record is ⊥
  * malformed_citation     — meta.sources entries outside /sources/…
  * unsupported_fact       — ``fact: k=v`` lines on a page with no sources
  * cross_page_contradiction — the same fact key bound to different values
                               on different pages
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field, replace

from . import paths as P
from . import records as R
from .consistency import WikiWriter
from .oracle import Oracle
from .store import PathStore

ERRORBOOK_PATH = "/_meta/errorbook"

_WIKILINK_RE = re.compile(r"\[\[(/[^\]\s]+)\]\]")
# value stops at whitespace/;/. so sentence punctuation never becomes part
# of the binding ("=twelve" vs "=twelve." is not a contradiction)
_FACT_RE = re.compile(r"fact:\s*([a-z0-9_]+)\s*=\s*([^\s;.]+)", re.I)


@dataclass
class ErrorBook:
    """Constraint rules + error tallies, persisted across runs."""

    rules: list[str] = field(default_factory=list)
    bad_link_targets: list[str] = field(default_factory=list)
    fact_bindings: dict[str, str] = field(default_factory=dict)
    tallies: dict[str, int] = field(default_factory=dict)
    repairs: dict[str, int] = field(default_factory=dict)

    def add_rule(self, rule: str) -> None:
        if rule not in self.rules:
            self.rules.append(rule)

    def tally(self, kind: str, n: int = 1) -> None:
        self.tallies[kind] = self.tallies.get(kind, 0) + n

    def repaired(self, kind: str, n: int = 1) -> None:
        self.repairs[kind] = self.repairs.get(kind, 0) + n

    # -- persistence ----------------------------------------------------
    # ``store`` may be a PathStore or a WikiWriter; the writer path also
    # publishes the invalidation so the device mirror/cache stay fresh.
    def save(self, store) -> None:
        store.put_record(ERRORBOOK_PATH, R.FileRecord(
            name="errorbook",
            text=json.dumps({
                "rules": self.rules,
                "bad_link_targets": self.bad_link_targets,
                "fact_bindings": self.fact_bindings,
                "tallies": self.tallies,
                "repairs": self.repairs,
            }, sort_keys=True)))

    @classmethod
    def load(cls, store: PathStore) -> "ErrorBook":
        rec = store.get(ERRORBOOK_PATH)
        if rec is None or not isinstance(rec, R.FileRecord) or not rec.text:
            return cls()
        o = json.loads(rec.text)
        return cls(rules=o.get("rules", []),
                   bad_link_targets=o.get("bad_link_targets", []),
                   fact_bindings=o.get("fact_bindings", {}),
                   tallies=o.get("tallies", {}),
                   repairs=o.get("repairs", {}))

    # -- ingestion-prompt injection --------------------------------------
    def ingestion_constraints(self) -> list[str]:
        """Rules surfaced to the ingestor (the paper injects these into
        subsequent ingestion prompts)."""
        return list(self.rules)


@dataclass
class ErrorReport:
    found: dict[str, list[str]] = field(default_factory=dict)

    def add(self, kind: str, where: str) -> None:
        self.found.setdefault(kind, []).append(where)

    @property
    def total(self) -> int:
        return sum(len(v) for v in self.found.values())


def detect_errors(store: PathStore, book: ErrorBook) -> ErrorReport:
    report = ErrorReport()
    fact_seen: dict[str, tuple[str, str]] = dict()  # key -> (value, path)
    for path in store.all_paths():
        if P.is_prefix(P.META_PREFIX, path):
            continue
        rec = store.get(path)
        if not isinstance(rec, R.FileRecord):
            continue
        # dangling wikilinks
        for target in _WIKILINK_RE.findall(rec.text):
            try:
                tnorm = P.normalize(target, depth_budget=None)
            except P.PathError:
                report.add("dangling_wikilink", f"{path} -> {target}")
                continue
            if store.get(tnorm) is None:
                report.add("dangling_wikilink", f"{path} -> {tnorm}")
        # malformed citations
        for src in rec.meta.sources:
            if not P.is_prefix(P.SOURCES_PREFIX, src):
                report.add("malformed_citation", f"{path} :: {src}")
        # unsupported facts
        facts = _FACT_RE.findall(rec.text)
        if facts and not rec.meta.sources and not P.is_prefix(P.SOURCES_PREFIX, path):
            report.add("unsupported_fact", path)
        # cross-page contradictions
        for k, v in facts:
            if k in fact_seen and fact_seen[k][0] != v:
                report.add("cross_page_contradiction",
                           f"{k}: {fact_seen[k][1]}={fact_seen[k][0]} vs {path}={v}")
            else:
                fact_seen.setdefault(k, (v, path))
    for kind, items in report.found.items():
        book.tally(kind, len(items))
    return report


def deterministic_repair(writer: WikiWriter, book: ErrorBook,
                         report: ErrorReport) -> int:
    """Code-level fixes, run after every ingestion batch (paper §III-E)."""
    store = writer.store
    fixed = 0
    # drop dangling links + record constraint rules
    for item in report.found.get("dangling_wikilink", []):
        path, _, target = item.partition(" -> ")
        rec = store.get(path)
        if not isinstance(rec, R.FileRecord):
            continue
        new_text = rec.text.replace(f"[[{target}]]", target.rsplit("/", 1)[-1])
        if new_text != rec.text:
            writer.put_record(path, replace(rec, text=new_text))
            fixed += 1
        if target not in book.bad_link_targets:
            book.bad_link_targets.append(target)
        book.add_rule(f"do-not-link:{target}")
    # strip malformed citations
    for item in report.found.get("malformed_citation", []):
        path, _, src = item.partition(" :: ")
        rec = store.get(path)
        if not isinstance(rec, R.FileRecord):
            continue
        writer.put_record(path, replace(
            rec, meta=replace(rec.meta,
                              sources=[s for s in rec.meta.sources
                                       if P.is_prefix(P.SOURCES_PREFIX, s)])))
        book.add_rule("citations-must-be-source-paths")
        fixed += 1
    # unsupported facts: demote confidence (repair happens at LLM layer)
    for path in report.found.get("unsupported_fact", []):
        rec = store.get(path)
        if not isinstance(rec, R.FileRecord):
            continue
        writer.put_record(path, replace(
            rec, meta=replace(rec.meta,
                              confidence=min(rec.meta.confidence, 0.3))))
        book.add_rule("facts-require-citations")
        fixed += 1
    book.repaired("deterministic", fixed)
    return fixed


def llm_repair(writer: WikiWriter, oracle: Oracle, book: ErrorBook,
               report: ErrorReport) -> int:
    """Periodic oracle-based fix loop: resolve contradictions by re-deriving
    the fact from the cited sources (majority of source support wins)."""
    store = writer.store
    fixed = 0
    for item in report.found.get("cross_page_contradiction", []):
        # "k: p1=v1 vs p2=v2" — keep the binding supported by more sources
        head, _, rest = item.partition(": ")
        left, _, right = rest.partition(" vs ")
        p1, v1 = left.rsplit("=", 1)
        p2, v2 = right.rsplit("=", 1)
        r1, r2 = store.get(p1), store.get(p2)
        if not (isinstance(r1, R.FileRecord) and isinstance(r2, R.FileRecord)):
            continue
        keep_first = len(r1.meta.sources) >= len(r2.meta.sources)
        loser_path, loser, good_v = (
            (p2, r2, v1) if keep_first else (p1, r1, v2))
        bad_v = v2 if keep_first else v1
        new_text = loser.text.replace(
            f"fact: {head}={bad_v}", f"fact: {head}={good_v}")
        if new_text != loser.text:
            def _mut(r, t=new_text):
                return replace(r, text=t)
            writer.update_file(loser_path, _mut)
            fixed += 1
        book.fact_bindings[head] = good_v
        book.add_rule(f"fact-binding:{head}={good_v}")
    book.repaired("llm", fixed)
    return fixed


def run_errorbook(writer: WikiWriter, oracle: Oracle,
                  with_llm_pass: bool = False) -> tuple[ErrorBook, ErrorReport]:
    """One Error Book cycle: load persisted state, detect, repair, persist."""
    book = ErrorBook.load(writer.store)
    report = detect_errors(writer.store, book)
    deterministic_repair(writer, book, report)
    if with_llm_pass:
        llm_repair(writer, oracle, book, report)
    book.save(writer)
    return book, report

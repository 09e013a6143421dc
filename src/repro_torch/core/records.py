"""Value schema (paper §IV-B).

Internal nodes (Index, Dimension) are *directory records*; leaves (Entity,
Digest, Document) are *file records*.  Directory records co-locate the child
lists so that ``LS(π) ≡ GET(π)`` — a single point lookup, no prefix scan.

Meta counters (``access_count``, ``confidence``, ``last_verified``,
``version``) are unused by the storage operators but feed the
schema-evolution operators of core/evolution.py, exactly as §IV-B notes.

Records serialize to a compact, deterministic JSON encoding (sorted keys) so
that byte-level equality == logical equality, which the OCC tests rely on.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any

DIR_TYPE = "dir"
FILE_TYPE = "file"


@dataclass
class DirMeta:
    updated_at: float = 0.0
    entry_count: int = 0
    access_count: int = 0

    def to_obj(self) -> dict[str, Any]:
        return {
            "updated_at": self.updated_at,
            "entry_count": self.entry_count,
            "access_count": self.access_count,
        }

    @classmethod
    def from_obj(cls, o: dict[str, Any]) -> "DirMeta":
        return cls(
            updated_at=float(o.get("updated_at", 0.0)),
            entry_count=int(o.get("entry_count", 0)),
            access_count=int(o.get("access_count", 0)),
        )


@dataclass
class FileMeta:
    version: int = 0
    confidence: float = 1.0
    sources: list[str] = field(default_factory=list)
    last_verified: float = 0.0
    access_count: int = 0

    def to_obj(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "confidence": self.confidence,
            "sources": list(self.sources),
            "last_verified": self.last_verified,
            "access_count": self.access_count,
        }

    @classmethod
    def from_obj(cls, o: dict[str, Any]) -> "FileMeta":
        return cls(
            version=int(o.get("version", 0)),
            confidence=float(o.get("confidence", 1.0)),
            sources=list(o.get("sources", [])),
            last_verified=float(o.get("last_verified", 0.0)),
            access_count=int(o.get("access_count", 0)),
        )


@dataclass
class DirRecord:
    """type="dir": name + two parallel child arrays + meta statistics."""

    name: str
    sub_dirs: list[str] = field(default_factory=list)
    files: list[str] = field(default_factory=list)
    meta: DirMeta = field(default_factory=DirMeta)
    # optional summary payload shown at index/dimension level by NAV r1/r2
    summary: str = ""

    type: str = DIR_TYPE

    def children(self) -> list[str]:
        """Ordered child *segments* (dirs first, then files) — the directory
        listing contract of Q2."""
        return list(self.sub_dirs) + list(self.files)

    def with_child(self, segment: str, *, is_dir: bool) -> "DirRecord":
        """Functional append used by the parent-after-child writer."""
        sd, fl = list(self.sub_dirs), list(self.files)
        target = sd if is_dir else fl
        if segment not in target:
            target.append(segment)
        meta = replace(self.meta, entry_count=len(sd) + len(fl))
        return replace(self, sub_dirs=sd, files=fl, meta=meta)

    def without_child(self, segment: str) -> "DirRecord":
        sd = [s for s in self.sub_dirs if s != segment]
        fl = [s for s in self.files if s != segment]
        meta = replace(self.meta, entry_count=len(sd) + len(fl))
        return replace(self, sub_dirs=sd, files=fl, meta=meta)

    def to_bytes(self) -> bytes:
        return _enc({
            "type": DIR_TYPE,
            "name": self.name,
            "sub_dirs": self.sub_dirs,
            "files": self.files,
            "summary": self.summary,
            "meta": self.meta.to_obj(),
        })


@dataclass
class FileRecord:
    """type="file": name + UTF-8 payload + meta (version is the OCC token)."""

    name: str
    text: str = ""
    meta: FileMeta = field(default_factory=FileMeta)

    type: str = FILE_TYPE

    def to_bytes(self) -> bytes:
        return _enc({
            "type": FILE_TYPE,
            "name": self.name,
            "text": self.text,
            "meta": self.meta.to_obj(),
        })


Record = DirRecord | FileRecord


def _enc(obj: dict[str, Any]) -> bytes:
    return json.dumps(obj, sort_keys=True, ensure_ascii=False,
                      separators=(",", ":")).encode("utf-8")


def decode(data: bytes) -> Record:
    o = json.loads(data.decode("utf-8"))
    t = o.get("type")
    if t == DIR_TYPE:
        return DirRecord(
            name=o.get("name", ""),
            sub_dirs=list(o.get("sub_dirs", [])),
            files=list(o.get("files", [])),
            summary=o.get("summary", ""),
            meta=DirMeta.from_obj(o.get("meta", {})),
        )
    if t == FILE_TYPE:
        return FileRecord(
            name=o.get("name", ""),
            text=o.get("text", ""),
            meta=FileMeta.from_obj(o.get("meta", {})),
        )
    raise ValueError(f"unknown record type {t!r}")


def encode(rec: Record) -> bytes:
    return rec.to_bytes()

"""Path-as-key encoding (paper §IV-A).

A node's path ``π(v)`` is its logical address.  The *physical* KV key is the
64-bit hash digest ``H(π(v))`` so that keys are fixed-width and
separator/charset agnostic (the paper calls out non-ASCII segments).

Normalization rules (paper §IV-A):
  * no trailing slash (except the root ``"/"`` itself),
  * case-sensitive segment matching (we do NOT casefold),
  * the reserved separator ``/`` may not appear inside a segment,
  * depth bounded by the schema constant ``D``.

The same normalization runs on the host (python strings) and — packed into
uint8 token matrices — on device (``core.tensorstore`` / ``kernels.prefix_search``),
so a path is simultaneously a tree address and, via ``H(π)``, a storage key,
with no translation table.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable

SEP = "/"
ROOT = "/"
#: default depth budget D (five node types: Index, Dimension, Entity, Digest, Document)
DEFAULT_DEPTH_BUDGET = 5
#: reserved subtree that hoists shared sources (paper §IV-A)
SOURCES_PREFIX = "/sources"
#: reserved, unadvertised metadata namespace (positioning 𝒫, error book, …)
META_PREFIX = "/_meta"
DIGESTS_PREFIX = "/sources/digests"
ARTICLES_PREFIX = "/sources/articles"

_SEGMENT_BAD = re.compile(r"[\x00/]")


class PathError(ValueError):
    """Raised on malformed or constraint-violating paths."""


def normalize(path: str, *, depth_budget: int | None = DEFAULT_DEPTH_BUDGET) -> str:
    """Normalize a raw path string to canonical form.

    Collapses duplicate separators, strips a trailing slash, validates
    segments and the depth budget.  Idempotent: ``normalize(normalize(p)) ==
    normalize(p)``.
    """
    if not isinstance(path, str) or not path:
        raise PathError(f"empty or non-string path: {path!r}")
    if not path.startswith(SEP):
        raise PathError(f"path must be absolute (start with '/'): {path!r}")
    segs = [s for s in path.split(SEP) if s != ""]
    for s in segs:
        if _SEGMENT_BAD.search(s):
            raise PathError(f"reserved character in segment {s!r} of {path!r}")
        if s in (".", ".."):
            raise PathError(f"relative segment {s!r} not allowed in {path!r}")
    if depth_budget is not None and len(segs) > depth_budget:
        raise PathError(
            f"path depth {len(segs)} exceeds budget {depth_budget}: {path!r}")
    if not segs:
        return ROOT
    return SEP + SEP.join(segs)


def is_normalized(path: str) -> bool:
    try:
        return normalize(path, depth_budget=None) == path
    except PathError:
        return False


def segments(path: str) -> list[str]:
    """Split a normalized path into its segment list; root → []."""
    if path == ROOT:
        return []
    return path.lstrip(SEP).split(SEP)


def depth(path: str) -> int:
    return len(segments(path))


def parent(path: str) -> str:
    """Parent path; the root is its own parent sentinel ``None`` is avoided —
    calling parent('/') is an error (the root has no parent)."""
    segs = segments(path)
    if not segs:
        raise PathError("root path has no parent")
    if len(segs) == 1:
        return ROOT
    return SEP + SEP.join(segs[:-1])


def child(path: str, segment: str) -> str:
    """Join one segment under ``path`` (both sides validated)."""
    if _SEGMENT_BAD.search(segment) or not segment:
        raise PathError(f"bad child segment {segment!r}")
    if path == ROOT:
        return SEP + segment
    return path + SEP + segment


def basename(path: str) -> str:
    segs = segments(path)
    return segs[-1] if segs else ""


def is_prefix(prefix: str, path: str) -> bool:
    """Segment-aware prefix test: ``/a`` is a prefix of ``/a/b`` but not of
    ``/ab``.  The root is a prefix of every path."""
    if prefix == ROOT:
        return True
    return path == prefix or path.startswith(prefix + SEP)


def ancestors(path: str) -> Iterable[str]:
    """Yield every proper ancestor from the root down (root first)."""
    segs = segments(path)
    yield ROOT
    for i in range(1, len(segs)):
        yield SEP + SEP.join(segs[:i])


# ---------------------------------------------------------------------------
# 64-bit FNV-1a hash — the physical key H(π).  Chosen because it is trivially
# expressible both in python (host ingest path) and as a vectorizable integer
# recurrence on device (uint32 pairs; see core/tensorstore.py), with no
# dependency on hashlib state.
# ---------------------------------------------------------------------------
FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def path_hash(path: str) -> int:
    """64-bit FNV-1a of the UTF-8 bytes of the *normalized* path."""
    h = FNV_OFFSET
    for b in path.encode("utf-8"):
        h ^= b
        h = (h * FNV_PRIME) & _MASK64
    return h


def key_bytes(path: str) -> bytes:
    """Physical key: 8-byte big-endian digest (sorts like the integer)."""
    return path_hash(path).to_bytes(8, "big")


@dataclass(frozen=True)
class PathKey:
    """A normalized logical path together with its physical digest."""

    path: str
    digest: int

    @classmethod
    def of(cls, raw: str, *, depth_budget: int | None = DEFAULT_DEPTH_BUDGET) -> "PathKey":
        p = normalize(raw, depth_budget=depth_budget)
        return cls(path=p, digest=path_hash(p))


# -- node-type binding (paper Table I) --------------------------------------
NODE_INDEX = "index"
NODE_DIMENSION = "dimension"
NODE_ENTITY = "entity"
NODE_DIGEST = "digest"
NODE_DOCUMENT = "document"


def is_reserved(path: str) -> bool:
    """True for the unadvertised metadata namespace and the hoisted sources
    subtree — excluded from schema shape (Eq. 1) and NAV results."""
    return is_prefix(META_PREFIX, path) or is_prefix(SOURCES_PREFIX, path)


def node_type(path: str) -> str:
    """Infer the schema node type from a normalized path (paper Table I)."""
    segs = segments(path)
    if not segs:
        return NODE_INDEX
    if is_prefix(DIGESTS_PREFIX, path) and depth(path) == 3:
        return NODE_DIGEST
    if is_prefix(ARTICLES_PREFIX, path) and depth(path) == 3:
        return NODE_DOCUMENT
    if len(segs) == 1:
        return NODE_DIMENSION
    if len(segs) == 2:
        return NODE_ENTITY
    # deeper entity subtrees produced by PageSplit stay entities
    return NODE_ENTITY


def digest_path(title: str) -> str:
    return child(DIGESTS_PREFIX, _safe_segment(title))


def article_path(title: str) -> str:
    return child(ARTICLES_PREFIX, _safe_segment(title))


def _safe_segment(title: str) -> str:
    """Make an arbitrary title usable as one path segment."""
    s = title.strip().replace(SEP, "_").replace("\x00", "")
    return s or "untitled"

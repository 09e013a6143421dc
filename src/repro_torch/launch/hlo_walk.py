"""Trip-count-aware HLO cost walker.

XLA's ``HloCostAnalysis`` (behind ``compiled.cost_analysis()``) visits a
``while`` body **once** — for scan-over-layers models that undercounts
flops/bytes/collectives by the layer count.  This walker parses the
optimized HLO text, recovers each while loop's trip count from its
condition (``compare(iter, constant(N))`` pattern), and accumulates

  * ``flops``            — 2·M·N·K for every dot (batch dims included),
  * ``bytes``            — operand+result bytes of every traffic-bearing
                           op (fusions count their boundary, matching the
                           HBM-traffic model),
  * ``collectives``      — per-op-kind counts and bytes,

each multiplied by the product of enclosing trip counts.  Conditionals
take the max across branches; fusion/call bodies are charged to the call
site (not double-counted at top level).

This is the measurement backbone of EXPERIMENTS.md §Roofline/§Perf.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^)]*\)|[\w\[\],{}]+))\s+"
    r"([\w\-]+)\((.*)$")
_CALLEE_RE = re.compile(r"(?:to_apply|body|condition|branch_computations|"
                        r"called_computations)=\{?%?([\w.\-]+(?:,\s*%?[\w.\-]+)*)\}?")
_CONST_RE = re.compile(r"constant\((\d+)\)")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(shape_str: str) -> list[int]:
    m = _SHAPE_RE.search(shape_str)
    if not m:
        return []
    return [int(d) for d in m.group(2).split(",") if d]


@dataclass
class _Op:
    name: str
    kind: str
    result: str
    rest: str


@dataclass
class _Computation:
    name: str
    ops: list = field(default_factory=list)
    shapes: dict = field(default_factory=dict)   # op name -> result shape str

    def operand_shapes(self, op: "_Op") -> list[str]:
        args = op.rest.split(")")[0]
        return [self.shapes[n] for n in re.findall(r"%([\w.\-]+)", args)
                if n in self.shapes]


def parse_computations(hlo: str) -> dict[str, _Computation]:
    comps: dict[str, _Computation] = {}
    cur: _Computation | None = None
    for line in hlo.splitlines():
        stripped = line.strip()
        if (stripped.endswith("{") and "->" in stripped
                and " = " not in stripped):
            m = _COMP_HDR.match(stripped)
            if m:
                cur = _Computation(m.group(1))
                comps[cur.name] = cur
                continue
        if stripped == "}":
            cur = None
            continue
        if cur is None:
            continue
        m = _OP_RE.match(line)
        if m:
            op = _Op(m.group(1), m.group(3), m.group(2), m.group(4))
            cur.ops.append(op)
            cur.shapes[op.name] = op.result
    return comps


def _dot_flops(op: _Op, comp: _Computation) -> float:
    """2 × |result| × |contraction|: result shape × lhs contracting dims
    (lhs shape resolved through the computation's symbol table)."""
    res = 1
    for d in _shape_dims(op.result):
        res *= d
    opers = comp.operand_shapes(op)
    if not opers:
        return 0.0
    lhs_dims = _shape_dims(opers[0])
    cdims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.rest)
    contr = 1
    if cdims and cdims.group(1):
        for i in cdims.group(1).split(","):
            di = int(i)
            if di < len(lhs_dims):
                contr *= lhs_dims[di]
    return 2.0 * res * contr


_SKIP_BYTES = {"parameter", "constant", "tuple", "get-tuple-element",
               "bitcast", "reshape", "after-all", "partition-id",
               "replica-id", "custom-call"}


def _trip_count(cond: _Computation) -> int:
    """Best-effort: the largest integer constant in the condition.  Covers
    lax.scan/map/fori (compare(iter, constant(N)))."""
    best = 1
    for op in cond.ops:
        if op.kind == "constant":
            # op line was split at "constant(" → rest starts with "N)"
            m = re.match(r"(\d+)\)", op.rest)
            if m:
                best = max(best, int(m.group(1)))
        m = _CONST_RE.search(op.rest)
        if m:
            best = max(best, int(m.group(1)))
    return best


@dataclass
class WalkResult:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)
    while_trips: list = field(default_factory=list)
    bytes_by_kind: dict = field(default_factory=dict)
    top_ops: dict = field(default_factory=dict)   # "kind result" -> bytes

    def as_dict(self) -> dict:
        top = dict(sorted(self.top_ops.items(), key=lambda kv: -kv[1])[:20])
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "collectives": self.collectives,
                "while_trips": self.while_trips,
                "bytes_by_kind": dict(sorted(
                    self.bytes_by_kind.items(), key=lambda kv: -kv[1])[:15]),
                "top_ops": top}


def walk(hlo: str, entry: str | None = None) -> WalkResult:
    comps = parse_computations(hlo)
    if not comps:
        return WalkResult()
    if entry is None:
        m = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.M)
        entry = m.group(1) if m else next(iter(comps))
    out = WalkResult()

    def visit(comp_name: str, mult: float, depth: int = 0) -> None:
        comp = comps.get(comp_name)
        if comp is None or depth > 24:
            return
        for op in comp.ops:
            kind = op.kind
            if kind == "while":
                callees = dict(
                    re.findall(r"(body|condition)=%?([\w.\-]+)", op.rest))
                body, cond = callees.get("body"), callees.get("condition")
                trips = _trip_count(comps[cond]) if cond in comps else 1
                out.while_trips.append(trips)
                if body:
                    visit(body, mult * trips, depth + 1)
                continue
            if kind == "conditional":
                branches = re.search(
                    r"branch_computations=\{([^}]*)\}", op.rest)
                names = ([b.strip().lstrip("%") for b in
                          branches.group(1).split(",")] if branches else [])
                for b in names:  # upper bound: sum of branches
                    visit(b, mult, depth + 1)
                continue
            if kind in ("fusion", "call", "map", "reduce", "reduce-window",
                        "scatter", "sort", "select-and-scatter"):
                # charge boundary traffic here; also walk fused dots so
                # MXU work inside fusions is counted
                cal = re.search(r"(?:calls|to_apply)=%?([\w.\-]+)", op.rest)
                if kind in ("fusion", "call") and cal:
                    _visit_dots_only(cal.group(1), mult, depth + 1)
            if kind == "dot" or kind == "convolution":
                out.flops += mult * _dot_flops(op, comp)
            if kind in COLLECTIVES:
                b = _shape_bytes(op.result)
                rec = out.collectives.setdefault(
                    kind, {"count": 0.0, "bytes": 0.0})
                rec["count"] += mult
                rec["bytes"] += mult * b
                out.collective_bytes += mult * b
            if kind not in _SKIP_BYTES:
                # HBM-traffic model: dots really stream their operands
                # (weights re-read per loop iteration!); everything else
                # is charged result×2 (read≈write) — charging full
                # operands would bill a dynamic-slice for the whole
                # buffer it slices from (measured 59 TB of fiction on
                # xlstm's time scan before this rule).
                if kind in ("dot", "convolution"):
                    b = _shape_bytes(op.result)
                    for s in comp.operand_shapes(op):
                        b += _shape_bytes(s)
                else:
                    # result×2 (read≈write).  Known limitation, documented
                    # in EXPERIMENTS.md §Roofline: scan-carry update
                    # fusions (dynamic-update-slice of a stacked buffer)
                    # are billed at full buffer size per step, which
                    # overstates the memory term of long *serial* scans
                    # (xlstm's sLSTM time loop).  Attempted operand-aware
                    # in-place detection re-billed slice reads at full
                    # buffer size — strictly worse; reverted.
                    b = 2 * _shape_bytes(op.result)
                out.bytes += mult * b
                out.bytes_by_kind[kind] = (out.bytes_by_kind.get(kind, 0.0)
                                           + mult * b)
                key = f"{kind} {op.result[:64]}"
                out.top_ops[key] = out.top_ops.get(key, 0.0) + mult * b

    def _visit_dots_only(comp_name: str, mult: float, depth: int) -> None:
        comp = comps.get(comp_name)
        if comp is None or depth > 24:
            return
        for op in comp.ops:
            if op.kind == "dot" or op.kind == "convolution":
                out.flops += mult * _dot_flops(op, comp)
            elif op.kind in ("fusion", "call"):
                cal = re.search(r"(?:calls|to_apply)=%?([\w.\-]+)", op.rest)
                if cal:
                    _visit_dots_only(cal.group(1), mult, depth + 1)
            elif op.kind == "while":
                callees = dict(
                    re.findall(r"(body|condition)=%?([\w.\-]+)", op.rest))
                body, cond = callees.get("body"), callees.get("condition")
                trips = _trip_count(comps[cond]) if cond in comps else 1
                if body:
                    _visit_dots_only(body, mult * trips, depth + 1)

    visit(entry, 1.0)
    return out

"""Multi-pod dry run of the port (counterpart of ``repro/launch/dryrun.py``):
trace every (arch x shape x mesh) cell's sharded step as rank 0 of a
process group of 256 or 512 ranks that do not exist, allocating nothing.

Per cell this script:
  1. builds the production mesh (16x16 single-pod or 2x16x16 multi-pod)
     over the ``fake`` process group that ``main`` starts (rank 0 of 256
     or 512; its collectives return at once and move nothing),
  2. builds fake stand-ins (``FakeTensorMode``: shapes, dtypes and a
     device, no storage) for rank 0's arguments: its parameter shards
     (``abstract_params`` cut by ``spec_tree``), its AdamW state
     (``adamw_init(..., full=abstract_params(cfg))``, laid out as
     ``opt_spec_tree``), the global batch (``input_specs``; the meshed
     steps take it whole) and, for decode, its block of the decode state
     (``abstract_decode_state`` cut by ``decode_state_specs``),
  3. runs the meshed train, prefill or serve step (``models.model``) once
     on them under ``Counter``: the step's FLOPs, bytes, collectives, an
     op histogram and rank 0's memory.  On fake "cuda" (the default) the
     kernels' entries in ``kernels.ops`` go to their shape rules; on fake
     "cpu" (``--device cpu``) to their plain versions.  Either way each is
     recorded by its kernel's work rule alone, so a cell counts the same
     on both,
  4. writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` with
     the reference's keys where they mean the same (``status``,
     ``skip_reason``, ``memory``, ``cost``, ``collectives``, ``roofline``),
     ``trace_s`` in place of ``lower_s`` (there is no compile) and ``ops``
     in place of ``hlo_ops``.

The roofline's times are predictions from an H100 SXM's published rates,
not measurements.  A sharding that does not divide, or a shape a kernel
refuses, fails here as a compile does in the reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun ... --device cpu   # no CUDA build needed
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref
from collections import Counter as _Histogram
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import all_arch_ids, get_config
from ..models import model as M
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_init
from ..tree import map_like

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# H100 SXM rates for the roofline terms (per card)
PEAK_FLOPS = 989e12    # dense bf16 on the tensor cores (NVIDIA H100 SXM data sheet)
HBM_BW = 3.35e12       # HBM3 bytes/s (NVIDIA H100 SXM data sheet)
# A 16x16 mesh spans 32 nodes of 8 cards, so every axis crosses nodes and
# the slowest link of a collective is the inter-node network: one
# ConnectX-7 NDR InfiniBand port of 400 Gb/s per card (NVIDIA DGX H100
# user guide), 50 GB/s each way; NVLink (450 GB/s each way) joins only
# the 8 cards of a node
NET_BW = 50e9

#: c10d ops by the reference's collective kinds (``collective_bytes``)
_COLLECTIVES = {"_allgather_base_": "all-gather", "allgather_": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
                "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
                "reduce_scatter_tensor_coalesced_": "reduce-scatter",
                "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                "send": "collective-permute", "recv_": "collective-permute"}
#: allocations: they hold memory but move no bytes
_NO_TRAFFIC = ("empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided")


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Counter(TorchDispatchMode):
    """Counts a traced step, op by op, as rank 0 of the mesh sees it.

    * ``flops``: the matrix products' 2·M·N·K (``torch.utils.flop_counter``'s
      formulas), what ``launch/hlo_walk.py`` counts of a dot;
    * ``bytes``: operand plus result bytes of every op that is not a view:
      one that makes a new storage or writes into an argument (an
      allocation moves none; a composite op that inference mode hands
      over whole is counted by the ops it decomposes into);
    * ``collectives``: each c10d collective's kind, count and result
      bytes, as the reference's ``collective_bytes`` reckons them;
    * memory: the bytes of each storage an op makes (an output that is
      none of its inputs' storage, an allocation such as ``empty`` too),
      live until the storage is freed:
      ``peak`` is the most live at once, besides the step's arguments
      (``hold``);
    * ``ops``: how many times each op ran.

    Inside an entry of ``kernels.ops`` (``kernel``, through
    ``ops.TRACER``) the kernel's work rule is recorded and none of the
    ops within: a plain version and a shape rule count alike."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_rules = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, dict] = {}
        self.ops = _Histogram()
        self.live = self.peak = 0
        self._sizes: dict[int, int] = {}      # id(storage) -> bytes while alive
        self._held: set[int] = set()
        self._depth = 0

    # -- memory -----------------------------------------------------------
    def hold(self, tree) -> int:
        """Mark the storages of ``tree`` (the step's arguments) as there
        before the step; returns their bytes."""
        seen, total = set(), 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
                self._held.add(id(st))
                weakref.finalize(st, self._held.discard, id(st))
        return total

    def _freed(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def _track(self, out, inputs=()) -> bool:
        """Count the storages of ``out`` that are new (none of the inputs'
        and none seen before) as live; whether there was one (an op whose
        every result aliases an input is a view in effect)."""
        mine = {id(t.untyped_storage()) for t in inputs}
        fresh = False
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in mine or key in self._sizes or key in self._held:
                continue
            fresh = True
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key)
        return fresh

    def new_bytes(self, tree) -> int:
        """The bytes of the storages of ``tree`` that the step made."""
        keys = {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in _tensors(tree)}
        return sum(b for k, b in keys.items() if k not in self._held)

    # -- recording --------------------------------------------------------
    def kernel(self, name: str, work: tuple, fn, *args, **kw):
        """One kernel call: ``fn`` (its plain version or its shape rule)
        runs unrecorded; ``work`` = (FLOPs, bytes) is recorded."""
        self._depth += 1
        try:
            out = fn(*args, **kw)
        finally:
            self._depth -= 1
        self.flops += work[0]
        self.bytes += work[1]
        self.ops[name] += 1
        self._track(out, _tensors((args, kw)))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns, name = func.namespace, func._opname
        if self._depth or ns == "prim":          # inside a kernel, or a query
            return func(*args, **kwargs)
        if ns == "aten" and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            # under inference mode a composite op (matmul, einsum, to, ...)
            # arrives whole: count the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops[f"{ns}.{name}"] += 1
        inputs = _tensors((args, kwargs))
        kind = _COLLECTIVES.get(name) if ns == "c10d" else None
        if kind is not None:             # its result: the tensors of its first argument
            rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += _nbytes(_tensors(args[0]))
        rule = self._flop_rules.get(func._overloadpacket)
        if rule is not None:
            self.flops += rule(*args, **kwargs, out_val=out)
        # an allocation holds memory from the moment it is made (a buffer
        # a collective or a blockwise update writes into) but moves no bytes
        fresh = self._track(out, inputs)
        if name not in _NO_TRAFFIC and (fresh or _writes(func)):
            self.bytes += _nbytes(inputs) + _nbytes(_tensors(out))
        return out

    @contextlib.contextmanager
    def tracing(self):
        """Count what runs inside, the kernels' entries included
        (``kernels.ops.TRACER``)."""
        from ..kernels import ops
        if ops.TRACER is not None:
            raise RuntimeError("a dry-run counter is already tracing")
        ops.TRACER = self
        try:
            with self:
                yield self
        finally:
            ops.TRACER = None


def _writes(func) -> bool:
    """An op that writes into one of its arguments (``add_``, ``copy_``,
    ``index_put_``, a collective)."""
    return any(a.alias_info is not None and a.alias_info.is_write for a in func._schema.arguments)


# ---------------------------------------------------------------------------
# the reference's rules
# ---------------------------------------------------------------------------
def _opt_cfg(cfg: ModelConfig) -> AdamWConfig:
    # trillion-param configs need quantized moments to fit (see configs/kimi)
    if cfg.name.startswith("kimi"):
        return AdamWConfig(state_dtype="int8")
    if cfg.name.startswith(("dbrx", "jamba")):
        return AdamWConfig(state_dtype="bfloat16")
    return AdamWConfig(state_dtype="float32")


def skip_reason(cfg: ModelConfig, shape: M.ShapeSpec) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("SKIP(full-attn): 512k dense attention/KV is out of reach "
                "for a quadratic arch; DESIGN.md §4")
    return None


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------
def _blocks(tree, specs, mesh, device):
    """This rank's block of every leaf of ``tree`` (meta tensors) by
    ``specs`` (``None``: the whole leaf), as empty tensors on ``device``
    (fake under the caller's ``FakeTensorMode``)."""
    from ..distributed.sharding import shard_slices

    def block(t, spec=None):
        cut = shard_slices(t.shape, spec, mesh) if spec is not None else ()
        return torch.empty([s.stop - s.start for s in cut] or t.shape, dtype=t.dtype,
                           device=device)
    return map_like(block, tree) if specs is None else map_like(block, tree, specs)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def trace_cell(cfg: ModelConfig, shape: M.ShapeSpec, mesh, device: str = "cuda") -> dict:
    """Trace one cell's meshed step for this rank of ``mesh`` under
    ``Counter`` on fake tensors of ``device``: ``trace_s``, ``memory``,
    ``cost``, ``collectives`` and ``ops``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from .mesh import dp_axes, dp_size
    t0 = time.perf_counter()
    specs = M.spec_tree(cfg)
    counter = Counter()
    with FakeTensorMode(allow_non_fake_inputs=False):
        params = _blocks(M.abstract_params(cfg), specs, mesh, device)
        batch = _blocks(M.input_specs(cfg, shape), None, mesh, device)
        if shape.kind == "train":
            opt_cfg = _opt_cfg(cfg)
            opt = adamw_init(params, opt_cfg, full=M.abstract_params(cfg))
            step = M.make_train_step(cfg, opt_cfg, mesh=mesh)
            args = (params, opt, batch)
        elif shape.kind == "prefill":
            step = M.make_prefill_step(cfg, mesh)
            args = (params, batch)
        else:
            layout = os.environ.get("REPRO_CACHE_LAYOUT", "auto")
            state_specs = M.decode_state_specs(
                cfg, shape.global_batch, dp=dp_axes(mesh), dp_size=dp_size(mesh),
                cache_layout=layout, tp_size=mesh.size(mesh.mesh_dim_names.index("model")))
            state = _blocks(M.abstract_decode_state(cfg, shape.global_batch, shape.seq_len),
                            state_specs, mesh, device)
            step = M.make_serve_step(cfg, mesh, cache_layout=layout)
            args = (params, state, batch)
        arg_bytes = counter.hold(args)
        with counter.tracing():
            out = step(*args)
        out_bytes = counter.new_bytes(out)
        del out
    return {"trace_s": round(time.perf_counter() - t0, 2),
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": out_bytes,
                       "peak_live_size_in_bytes": counter.peak,
                       "total_per_device": arg_bytes + counter.peak},
            "cost": {"flops": counter.flops, "bytes accessed": counter.bytes},
            "collectives": dict(counter.collectives,
                                total_bytes=sum(r["bytes"] for r in counter.collectives.values())),
            "ops": dict(sorted(counter.ops.items(), key=lambda kv: -kv[1]))}


def lower_cell(arch: str, shape_name: str, multi_pod: bool, device: str = "cuda") -> dict:
    cfg = get_config(arch)
    shape = M.SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    result: dict = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
                    "device": device, "status": "skip", "skip_reason": reason}
    if reason is not None:
        return result
    from .mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    result.update(trace_cell(cfg, shape, mesh, device))
    result["status"] = "ok"
    result.update(roofline_terms(result, cfg, shape, mesh))
    return result


def roofline_terms(result: dict, cfg: ModelConfig, shape: M.ShapeSpec, mesh) -> dict:
    chips = mesh.size()
    flops = result["cost"].get("flops", 0.0)
    byts = result["cost"].get("bytes accessed", 0.0)
    coll = result["collectives"].get("total_bytes", 0)
    # the counts are one rank's (the meshed step is one rank's program)
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = coll / NET_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    mf = M.model_flops(cfg, shape)
    return {
        "roofline": {
            "chips": chips,
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "dominant": dominant,
            "model_flops_total": mf,
            "model_flops_per_chip": mf / chips,
            "useful_flops_ratio": (mf / chips) / flops if flops else 0.0,
        }
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, device: str = "cuda",
             out_dir: Path = ARTIFACTS) -> dict:
    multi = mesh_kind == "multi"
    try:
        res = lower_cell(arch, shape_name, multi, device)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        res = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi),
               "device": device, "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out_dir.mkdir(parents=True, exist_ok=True)
    fn = out_dir / f"{arch}__{shape_name}__{res['mesh']}.json"
    fn.write_text(json.dumps(res, indent=1, default=str))
    return res


def start_fake_group(world_size: int) -> None:
    """The ``fake`` process group of ``world_size`` ranks, this process its
    rank 0: collectives return at once and move nothing.  Refuses to run
    where a process group exists already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; one exists "
                           "already in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device: cuda (the kernels' shape rules; needs "
                         "PyTorch built with CUDA) or cpu (their plain versions)")
    ap.add_argument("--out-dir", type=Path, default=ARTIFACTS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("--device cuda traces on fake CUDA tensors and needs PyTorch built "
                           "with CUDA; pass --device cpu to trace through the plain versions")
    import torch.distributed as dist

    archs = all_arch_ids() if args.all or args.arch is None else [args.arch]
    shapes = list(M.SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    ok = bad = skip = 0
    for mk in meshes:        # one fake group of 256 or 512 ranks a mesh
        start_fake_group(512 if mk == "multi" else 256)
        try:
            for arch in archs:
                for shape_name in shapes:
                    mesh_name = _mesh_name(mk == "multi")
                    fn = args.out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
                    if args.skip_existing and fn.exists():
                        prev = json.loads(fn.read_text())
                        if prev.get("status") in ("ok", "skip"):
                            print(f"[cached] {arch} {shape_name} {mesh_name} "
                                  f"{prev['status']}", flush=True)
                            ok += prev["status"] == "ok"
                            skip += prev["status"] == "skip"
                            continue
                    t0 = time.time()
                    res = run_cell(arch, shape_name, mk, args.device, args.out_dir)
                    dt = time.time() - t0
                    st = res["status"]
                    ok += st == "ok"
                    bad += st == "error"
                    skip += st == "skip"
                    line = f"[{st:5s}] {arch:18s} {shape_name:12s} {mesh_name:8s} {dt:7.1f}s"
                    if st == "ok":
                        r = res["roofline"]
                        line += (f" dom={r['dominant']:10s}"
                                 f" tc={r['t_compute_s']:.3e}"
                                 f" tm={r['t_memory_s']:.3e}"
                                 f" tx={r['t_collective_s']:.3e}"
                                 f" mem={res['memory']['total_per_device']/2**30:.1f}GiB"
                                 f" useful={r['useful_flops_ratio']:.4f}")
                    elif st == "error":
                        line += " " + res["error"][:160]
                    print(line, flush=True)
        finally:
            dist.destroy_process_group()
    print(f"\nDRYRUN SUMMARY ok={ok} skip={skip} error={bad}", flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

"""The port's mesh over ``torch.distributed`` on 4 gloo ranks on the CPU,
against the JAX package and the unmeshed port.

One module-scoped fixture starts 4 processes once (gloo, CPU tensors,
``tcp://localhost`` at a free port), under a timeout of its own, so a
hung rank fails these tests instead of holding the run; each rank writes
its results to a file that the four tests below read:

* expert-parallel MoE on a (2, 2) ("data", "model") mesh (reduced dbrx,
  8 experts, capacity factor 8): each rank's rows (the batch split over
  "data") against JAX's local ``moe_apply`` within the reference's 2e-4,
  and the gradients of x, the router and the experts (summed over the
  ranks that hold parts of them) against the port's local path under
  autograd within 2e-4 of each leaf's largest;
* ``pipeline_apply`` (4 stages over "pod", 6 microbatches, width 8)
  against the stages applied in sequence, within 1e-5;
* the sharded train step of reduced qwen3 (B = 4, S = 32, f64, a quarter
  of the labels masked) on a (2, 2) mesh against the unmeshed step on the
  whole batch, 2 steps: the losses within 1e-5, every updated leaf within
  1e-5 of its largest, and each rank storing numel / shards of each leaf
  (in f64: AdamW's first step moves a weight by ~lr * g / (|g| + eps), so
  an f32 gradient near eps, summed in another order by the
  tensor-parallel products, moves it by a share of lr);
* ``restore_elastic`` of a checkpoint (f32 params and int8 AdamW moments)
  onto (4, 1) and (1, 1) meshes, each rank's blocks bit for bit the
  slices of the stored leaves (cut here independently of the port's
  slicer);
* the meshed eval, prefill and serve steps of reduced qwen3, dbrx and
  jamba on (2, 2) against the unmeshed port and JAX;
* the partitioned steps (each layer's leaves gathered on use, attention
  and the MLP tensor-parallel over "model", the sequence split there,
  remat) on (2, 2) and (1, 4) meshes for reduced qwen3 (its KV heads split
  at tp = 2 and read whole at tp = 4), qwen3 with 6 heads and 15 tokens
  (attention whole at tp = 4, the sequence never split), dbrx with 8
  experts, whisper and jamba's period: the loss and the gradients
  gathered from the shards within 1e-5 of each leaf's largest, eval and
  prefill within 1e-5 of the largest logit, 16 greedy serve steps' tokens
  exactly under the kv_head and head_dim layouts (qwen3: seq too), the
  bytes each gather returns (never more than one layer's leaves, embed or
  the head), and a kv_head serve step's collective bytes independent of
  the cache's length.

f32 but for the sharded train step; the sums over ranks run in another
order than the unmeshed ones, hence the tolerances.
"""
import inspect
import json
import os
import socket
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import leaves, map_like  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
RANKS = 4
TIMEOUT_S = 200          # the whole 4-rank run, start to finish
S, MB, F = 4, 6, 8       # pipeline: stages, microbatches, width
LR = 1e-3

def _caches(state, specs=None):
    """Every attention cache of a decode state, by a name of its own:
    (name, cache tensor, its spec in ``specs``, the states' specs, or None)."""
    for slot in sorted(state):
        st, sp = state[slot], (specs or {}).get(slot)
        for j, c in (enumerate(st) if isinstance(st, list) else [("", st)]):
            if isinstance(c, dict):
                cs = sp[j] if isinstance(st, list) and sp else sp
                for n in ("k", "v"):
                    yield f"{slot}{j}_{n}", c[n], cs[n] if cs else None


def _recurrent(state, specs=None):
    """Every recurrent state tensor of a decode state, by a name of its
    own: (name, tensor, its spec in ``specs`` or None)."""
    for slot in sorted(state):
        st, sp = state[slot], (specs or {}).get(slot)
        if isinstance(st, tuple):
            for i, t in enumerate(st):
                yield f"{slot}_{i}", t, sp[i] if sp else None


_WORKER = inspect.getsource(_caches) + inspect.getsource(_recurrent) + r'''
import json
import sys
from datetime import timedelta
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

rank, port, work = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4, timeout=timedelta(seconds=120))
from dataclasses import replace
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint.manager import CheckpointManager, restore_elastic
from repro_torch.configs import get_config
from repro_torch.distributed.pipeline import PipelineSchedule, pipeline_apply
from repro_torch.distributed.sharding import all_reduce
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.tree import leaves
out = {}

# (a) expert-parallel MoE on (2, 2)
mesh = make_host_mesh(2, 2)
cfg = get_config("dbrx-132b").reduced()
cfg = replace(cfg, moe=replace(cfg.moe, n_experts=8, capacity_factor=8.0))
a = np.load(work / "moe.npz")
p = {k: torch.from_numpy(a[k]).requires_grad_(True) for k in ("router", "w_gate", "w_up", "w_down")}
x = T.split_batch({"x": torch.from_numpy(a["x"])}, mesh)["x"].clone().requires_grad_(True)
y = MoE.moe_apply(p, x, cfg, mesh=mesh)
rows = T.split_batch({"r": torch.arange(a["x"].shape[0])}, mesh)["r"]
(y * T.split_batch({"c": torch.from_numpy(a["c"])}, mesh)["c"]).sum().backward()
out["moe_y"], out["moe_rows"], out["moe_dx"] = y.detach().numpy(), rows.numpy(), x.grad.numpy()
out["moe_drouter"] = all_reduce(p["router"].grad, ("data",), mesh).numpy()
for k in ("w_gate", "w_up", "w_down"):
    out["moe_d" + k] = all_reduce(p[k].grad, ("data", "model"), mesh).numpy()

# (b) the GPipe schedule over 4 "pod" ranks
pmesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("pod", "model"))
b = np.load(work / "pipe.npz")
sched = PipelineSchedule(n_stages=4, n_micro=b["xs"].shape[0], axis="pod")
got = pipeline_apply(lambda w, x: torch.tanh(x @ w), torch.from_numpy(b["ws"]),
                     torch.from_numpy(b["xs"]), sched, pmesh)
out["pipe"], out["bubble"] = got.numpy(), np.float64(sched.bubble_fraction)

# (c) the sharded train step of reduced qwen3 on (2, 2), in float64
qcfg = get_config("qwen3-1.7b").reduced(dtype="float64", param_dtype="float64")
c = np.load(work / "train.npz")
full = M.init_params(qcfg, seed=0, device="cpu")
params = M.shard_params(full, qcfg, mesh)
opt_cfg = AdamWConfig(lr=float(c["lr"]))
opt = adamw_init(params, opt_cfg)
step = M.make_train_step(qcfg, opt_cfg, total_steps=10, mesh=mesh)
losses = []
for i in range(2):
    batch = {"tokens": torch.from_numpy(c[f"tokens{i}"]), "labels": torch.from_numpy(c[f"labels{i}"])}
    params, opt, aux = step(params, opt, batch)
    losses.append(float(aux["loss"]))
out["train_losses"] = np.array(losses)
sh = M.param_shardings(qcfg, mesh)
out["placements"] = np.array([repr(sh["embed"]), repr(sh["body"]["slot0"]["attn"]["wq"]),
                              repr(sh["final_norm"]["scale"])])
from repro_torch.launch.mesh import make_production_mesh
try:
    make_production_mesh()
    out["production_refused"] = np.bool_(False)
except RuntimeError:
    out["production_refused"] = np.bool_(True)
out["train_numel"] = np.array([t.numel() for t in leaves(params)])
from repro_torch.distributed.sharding import gather
from repro_torch.tree import map_like
for i, t in enumerate(leaves(map_like(lambda t, s: gather(t, s, mesh), params,
                                      M.spec_tree(qcfg)))):
    out[f"train_leaf{i}"] = t.numpy()

# (c2) one int8-moment step of the checkpoint's config: the row scales of
# the MLP's w_gate and w_up, whose rows "model" cuts, over the whole rows
ccfg = get_config("qwen3-1.7b").reduced(vocab=1024, d_model=256, d_ff=512)
q_cfg = AdamWConfig(lr=float(c["lr"]), state_dtype="int8")
specs = M.spec_tree(ccfg)
pspecs = {"params": specs, "opt": M.opt_spec_tree(specs, q_cfg, ccfg)}
qp = M.shard_params(M.init_params(ccfg, seed=0, device="cpu"), ccfg, mesh)
qp, qo, _ = M.make_train_step(ccfg, q_cfg, total_steps=10, mesh=mesh)(
    qp, adamw_init(qp, q_cfg, full=M.abstract_params(ccfg)), {"tokens": torch.from_numpy(c["tokens0"]),
                                "labels": torch.from_numpy(c["labels0"])})
q_full = map_like(lambda t, s: gather(t, s, mesh), {"params": qp, "opt": qo}, pspecs)
for i, t in enumerate(leaves(q_full)):
    out[f"int8_leaf{i}"] = t.numpy()

# (d) restore_elastic onto (4, 1) and (1, 1)
like = {"params": M.abstract_params(ccfg), "opt": adamw_init(M.abstract_params(ccfg), q_cfg)}
mgr = CheckpointManager(work / "ckpt")
for name, shape in (("r41", (4, 1)), ("r11", (1, 1))):
    m = make_host_mesh(*shape)
    if m.get_coordinate() is None:
        continue
    step_no, tree, _ = restore_elastic(mgr, like, m, pspecs)
    out[name + "_step"] = np.int64(step_no)
    for i, t in enumerate(leaves(tree)):
        out[f"{name}_leaf{i}"] = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

# (e) the meshed eval, prefill and serve steps on (2, 2): reduced qwen3, and
# reduced dbrx and jamba with their MoE layers expert-parallel
from repro_torch.distributed.sharding import shard
from repro_torch.launch.mesh import dp_axes, dp_size
from repro_torch.tree import unflatten
cases = json.loads((work / "meshed.json").read_text())
for arch in cases["archs"]:
    cfg = get_config(arch).reduced(**({"n_layers": cases["n_layers"][arch]}
                                      if arch in cases["n_layers"] else {}))
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, n_experts=cases["n_experts"][arch],
                                       capacity_factor=cases["capacity_factor"]))
    a = np.load(work / f"meshed_{arch}.npz")
    whole = unflatten(M.abstract_params(cfg), [torch.from_numpy(a[f"leaf{i}"])
                                              for i in range(int(a["n_leaves"]))])
    params = M.shard_params(whole, cfg, mesh)
    batch = {"tokens": torch.from_numpy(a["tokens"]), "labels": torch.from_numpy(a["labels"])}
    out[f"{arch}_eval"] = np.float32(M.make_eval_step(cfg, mesh)(params, batch))
    logits = M.make_prefill_step(cfg, mesh)(params, {"tokens": batch["tokens"]})
    out[f"{arch}_prefill"] = logits.numpy()
    out[f"{arch}_prefill_rows"] = T.split_batch({"r": torch.arange(4)}, mesh)["r"].numpy()
    for layout, B in cases["serve_cases"][arch]:
        tag = f"{arch}_{layout}_{B}"
        specs = M.decode_state_specs(cfg, B, dp=dp_axes(mesh), dp_size=dp_size(mesh),
                                     cache_layout=layout, tp_size=2)
        state = map_like(lambda t, s: shard(t, s, mesh),
                         T.init_decode_state(cfg, B, cases["max_len"], "cpu"), specs)
        serve = M.make_serve_step(cfg, mesh, cache_layout=layout)
        toks, logs = [], []
        for i in range(cases["steps"]):
            nt, lg, state = serve(params, state, {"tokens": torch.from_numpy(a[f"serve{B}_tokens"][i]),
                                                 "lengths": torch.from_numpy(a[f"serve{B}_lengths"][i])})
            toks.append(nt.numpy())
            logs.append(lg.numpy())
        out[tag + "_toks"], out[tag + "_logits"] = np.stack(toks), np.stack(logs)
        out[tag + "_rows"] = T.split_batch({"r": torch.arange(B)}, mesh)["r"].numpy()

# (f) the partitioned steps on (2, 2) and (1, 4): each layer's leaves
# gathered on use, attention and the MLP tensor-parallel, the sequence
# split over "model", remat under grad; the bytes each gather returns, and
# the collective bytes of a kv_head serve step at two cache lengths
from repro_torch.distributed import sharding as SH
from repro_torch.launch.dryrun import Counter
part = json.loads((work / "partitioned.json").read_text())
gathered = []
_gather = SH.gather
# the gathers of each recurrent layer call (train, its recompute, prefill,
# serve): (kind, whether it carries a MoE FFN, the bytes they return); the
# gathers of a serve step whose input is a recurrent state
layer_bytes, in_layer, state_ptrs, state_gathers = [], [], set(), []


def counted_gather(t, spec, mesh, axes=None):
    got = _gather(t, spec, mesh, axes)
    gathered.append(got.numel() * got.element_size())
    if in_layer:
        in_layer[-1] += got.numel() * got.element_size()
    if t.untyped_storage().data_ptr() in state_ptrs:
        state_gathers.append(1)
    return got


def counted_layer(run):
    def layer(kind, local, *a, **k):
        in_layer.append(0)
        try:
            return run(kind, local, *a, **k)
        finally:
            got = in_layer.pop()
            if kind in T.RECURRENT_KINDS:
                layer_bytes.append((kind, "moe" in local, got))
    return layer


T._layer, T._decode_block = counted_layer(T._layer), counted_layer(T._decode_block)
SH.gather = counted_gather
for name, case in part["cases"].items():
    cfg = get_config(case["arch"]).reduced(**case["overrides"])
    if case.get("float64"):
        cfg = replace(cfg, dtype="float64", param_dtype="float64")
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, n_experts=case["n_experts"],
                                       capacity_factor=part["capacity_factor"]))
    a = np.load(work / f"part_{name}.npz")
    whole = unflatten(M.abstract_params(cfg), [torch.from_numpy(a[f"leaf{i}"])
                                              for i in range(int(a["n_leaves"]))])
    batch = {k: torch.from_numpy(a[k]) for k in case["batch"]}
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    for shape in part["meshes"]:
        mesh = make_host_mesh(*shape)
        tag = f"{name}_{shape[0]}x{shape[1]}"
        params = M.shard_params(whole, cfg, mesh)
        gathered.clear()
        layer_bytes.clear()
        loss, grads = M.loss_and_grads(params, batch, cfg, mesh)
        out[tag + "_prefill"] = M.make_prefill_step(cfg, mesh)(params, fwd).numpy()
        out[tag + "_gathered"] = np.array(gathered, np.int64)
        out[tag + "_loss"] = np.float32(loss)
        for i, t in enumerate(leaves(map_like(lambda t, s: gather(t, s, mesh), grads,
                                              M.spec_tree(cfg)))):
            out[f"{tag}_grad{i}"] = t.numpy()
        out[tag + "_eval"] = np.float32(M.make_eval_step(cfg, mesh)(params, batch))
        out[tag + "_rows"] = T.split_batch({"r": torch.arange(4)}, mesh)["r"].numpy()
        tp = shape[1]
        for layout in case["layouts"]:
            if layout == "kv_head" and cfg.n_kv_heads % tp:
                continue
            specs = M.decode_state_specs(cfg, 4, dp=dp_axes(mesh), dp_size=dp_size(mesh),
                                         cache_layout=layout, tp_size=tp)
            serve = M.make_serve_step(cfg, mesh, cache_layout=layout)
            extra = {"enc_out": torch.from_numpy(a["enc_out"])} if cfg.is_encdec else {}
            state = map_like(lambda t, s: shard(t, s, mesh),
                             T.init_decode_state(cfg, 4, part["max_len"], "cpu"), specs)
            state_ptrs.update(t.untyped_storage().data_ptr() for _, t, _ in _recurrent(state))
            state_gathers.clear()
            toks, logs = [], []
            for i in range(part["steps"]):
                nt, lg, state = serve(params, state, {"tokens": torch.from_numpy(a["serve_tokens"][i]),
                                                      "lengths": torch.from_numpy(a["serve_lengths"][i]),
                                                      **extra})
                toks.append(nt.numpy())
                logs.append(lg.numpy())
            out[f"{tag}_{layout}_toks"], out[f"{tag}_{layout}_logits"] = np.stack(toks), np.stack(logs)
            out[f"{tag}_{layout}_state_gathers"] = np.int64(len(state_gathers))
            state_ptrs.clear()
            if layout == "head_dim":
                # the rank's block of every recurrent state after the steps,
                # and where it lies in the whole state
                whole_rec = {key: t for key, t, _ in
                             _recurrent(T.init_decode_state(cfg, 4, part["max_len"], "meta"))}
                for key, t, sp in _recurrent(state, specs):
                    out[f"{tag}_state_{key}"] = t.numpy()
                    out[f"{tag}_state_{key}_at"] = np.array(
                        [(sl.start, sl.stop) for sl in
                         SH.shard_slices(whole_rec[key].shape, sp, mesh)], np.int64)
                # the rank's block of every attention cache after the steps,
                # and where it lies in the whole cache
                whole_state = {key: (t, sp) for key, t, sp in
                               _caches(T.init_decode_state(cfg, 4, part["max_len"], "meta"), specs)}
                for key, t, sp in _caches(state, specs):
                    out[f"{tag}_{layout}_{key}"] = t.numpy()
                    out[f"{tag}_{layout}_{key}_at"] = np.array(
                        [(sl.start, sl.stop) for sl in
                         SH.shard_slices(whole_state[key][0].shape, sp, mesh)], np.int64)
            if layout == "seq":
                continue
            # one step's collective bytes at two cache lengths, in all and
            # by kind (all-gather, all-reduce)
            moved, kinds = [], []
            for max_len in (part["max_len"], 2 * part["max_len"]):
                state = map_like(lambda t, s: shard(t, s, mesh),
                                 T.init_decode_state(cfg, 4, max_len, "cpu"), specs)
                counter = Counter()
                with counter.tracing():
                    serve(params, state, {"tokens": torch.from_numpy(a["serve_tokens"][0]),
                                          "lengths": torch.from_numpy(a["serve_lengths"][0]), **extra})
                moved.append(sum(r["bytes"] for r in counter.collectives.values()))
                kinds.append([counter.collectives.get(k, {}).get("bytes", 0)
                              for k in ("all-gather", "all-reduce")])
            out[f"{tag}_{layout}_moved"] = np.array(moved, np.int64)
            out[f"{tag}_{layout}_kinds"] = np.array(kinds, np.int64)
        out[tag + "_layer_bytes"] = np.array([(T.RECURRENT_KINDS.index(k), moe, b)
                                              for k, moe, b in layer_bytes], np.int64).reshape(-1, 3)
SH.gather = _gather

# (g) the vocab-parallel head and cross entropy in float64 on (2, 2) and
# (1, 4), under each remat policy (REPRO_REMAT_POLICY, read per step)
import os
v64 = json.loads((work / "vocab64.json").read_text())
for name, arch in v64["cases"].items():
    cfg = get_config(arch).reduced(dtype="float64", param_dtype="float64")
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, n_experts=v64["n_experts"],
                                       capacity_factor=v64["capacity_factor"]))
    a = np.load(work / f"v64_{name}.npz")
    whole = unflatten(M.abstract_params(cfg), [torch.from_numpy(a[f"leaf{i}"])
                                              for i in range(int(a["n_leaves"]))])
    batch = {k: torch.from_numpy(a[k]) for k in ("tokens", "labels")}
    for shape in v64["meshes"]:
        mesh = make_host_mesh(*shape)
        params = M.shard_params(whole, cfg, mesh)
        for policy in v64["policies"]:
            os.environ["REPRO_REMAT_POLICY"] = policy
            loss, grads = M.loss_and_grads(params, batch, cfg, mesh)
            tag = f"v64_{name}_{shape[0]}x{shape[1]}_{policy}"
            out[tag + "_loss"] = np.float64(loss)
            for i, t in enumerate(leaves(map_like(lambda t, s: gather(t, s, mesh), grads,
                                                  M.spec_tree(cfg)))):
                out[f"{tag}_grad{i}"] = t.numpy()
        os.environ.pop("REPRO_REMAT_POLICY", None)

np.savez(work / f"rank{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print("RANK DONE", rank)
'''


#: the meshed eval, prefill and serve steps: reduced configs, dbrx with 8
#: experts and both MoE configs at a capacity that drops nothing (the
#: meshed step's capacity is over a rank's rows, the unmeshed one's over
#: the whole batch); the serve step under each (cache layout, batch):
#: KV heads, head_dim and the sequence over "model" at B = 4, and at B = 1
#: (too small to split over "data") the sequence over "data"
MESHED = ("qwen3-1.7b", "dbrx-132b", "jamba-v0.1-52b")
SERVE_CASES = {"qwen3-1.7b": (("auto", 4), ("head_dim", 4), ("seq", 4), ("auto", 1)),
               "dbrx-132b": (("auto", 4),), "jamba-v0.1-52b": (("auto", 4),)}
SERVE_STEPS, MAX_LEN = 8, 32


N_EXPERTS = {"dbrx-132b": 8, "jamba-v0.1-52b": 4}
N_LAYERS = {"jamba-v0.1-52b": 8}        # one period: mamba, attention and MoE slots
CAPACITY = 8.0


def meshed_cfg(arch: str, get=get_config):
    """The reduced config of ``arch`` the meshed-step cases run (``get``:
    either package's ``get_config``)."""
    cfg = get(arch).reduced(**({"n_layers": N_LAYERS[arch]} if arch in N_LAYERS else {}))
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, n_experts=N_EXPERTS[arch],
                                       capacity_factor=CAPACITY))
    return cfg


def _meshed_inputs(work: Path, rs) -> dict:
    """Per arch: JAX's params (saved bridged, leaf by leaf, for the
    ranks), a batch, and JAX's ``loss_fn``, ``forward`` and 8 greedy
    ``make_serve_step`` steps at B = 4 and 1 (the input tokens and lengths
    of each step saved); and the unmeshed port's on the same inputs."""
    from repro.models import model as JM
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import transformer as T
    (work / "meshed.json").write_text(json.dumps({
        "archs": MESHED, "serve_cases": SERVE_CASES, "steps": SERVE_STEPS, "max_len": MAX_LEN,
        "n_experts": N_EXPERTS, "n_layers": N_LAYERS, "capacity_factor": CAPACITY}))
    refs = {}
    for arch in MESHED:
        cfg_j, cfg = meshed_cfg(arch, jget_config), meshed_cfg(arch)
        jparams = JM.init_params(cfg_j, seed=1)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        tokens = rs.randint(4, cfg.vocab, (4, 16)).astype(np.int32)
        labels = rs.randint(4, cfg.vocab, (4, 16)).astype(np.int32)
        labels[rs.rand(4, 16) < 0.25] = -1
        jb = {"tokens": jax.numpy.asarray(tokens), "labels": jax.numpy.asarray(labels)}
        tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
        ref = {"jax_eval": float(JT.loss_fn(jparams, jb, cfg_j)),
               "eval": float(M.make_eval_step(cfg)(params, tb)),
               "jax_prefill": np.asarray(JT.forward(jparams, {"tokens": jb["tokens"]}, cfg_j)),
               "prefill": M.make_prefill_step(cfg)(params, {"tokens": tb["tokens"]}).numpy()}
        save = {f"leaf{i}": t.numpy() for i, t in enumerate(leaves(params))}
        save.update(n_leaves=len(save), tokens=tokens, labels=labels)
        jserve, serve = jax.jit(JM.make_serve_step(cfg_j)), M.make_serve_step(cfg)
        for B in sorted({b for _, b in SERVE_CASES[arch]}):
            jstate = JT.init_decode_state(cfg_j, B, MAX_LEN)
            state = T.init_decode_state(cfg, B, MAX_LEN, "cpu")
            toks = rs.randint(4, cfg.vocab, B).astype(np.int32)
            lens = np.array([0, 3, 7, 1][:B], np.int32)
            ins, outs, logits, jouts = [], [], [], []
            for _ in range(SERVE_STEPS):
                ins.append((toks, lens))
                jn, _, jstate = jserve(jparams, jstate, {"tokens": toks, "lengths": lens})
                tn, tl, state = serve(params, state, {"tokens": torch.from_numpy(toks),
                                                      "lengths": torch.from_numpy(lens)})
                jouts.append(np.asarray(jn))
                outs.append(tn.numpy())
                logits.append(tl.numpy())
                toks, lens = np.asarray(jn).astype(np.int32), lens + 1
            save[f"serve{B}_tokens"] = np.stack([t for t, _ in ins])
            save[f"serve{B}_lengths"] = np.stack([n for _, n in ins])
            ref[f"serve{B}"] = (np.stack(jouts), np.stack(outs), np.stack(logits))
        np.savez(work / f"meshed_{arch}.npz", **save)
        refs[arch] = ref
    return refs


#: the partitioned steps on (2, 2) and (1, 4) ("data", "model"): reduced
#: qwen3 (its 4 query heads split over "model", its 2 KV heads split at
#: tp = 2 and read whole at tp = 4), qwen3 with 6 heads and 15 tokens (its
#: attention whole on every "model" rank at tp = 4, the sequence never
#: split), dbrx with 8 experts, whisper (the cross-attention over frames
#: split over "model"), jamba's period (its mamba slots channel-parallel)
#: and xlstm's period (7 mLSTM and 1 sLSTM block tensor-parallel; its 2
#: sLSTM heads split at tp = 2 and cut at tp = 4, where h is gathered a
#: time step); the MoE configs at a capacity that drops nothing.  jamba
#: and xlstm run in float64 (``float64``: JAX's f32 parameters widened for
#: the port): their recurrent layers are tensor-parallel, so the ranks sum
#: in another order than the unmeshed step, and in f32 a gradient of
#: theirs moves past 1e-5 of its largest under a rounding's difference
#: alone (jamba's last A_log by 1.65e-5 when the unmeshed step's embedding
#: is perturbed by 1e-7)
#: (qwen3, dbrx and jamba are the meshed cases' configs, params and batch;
#: the seq layout gathers the cache as head_dim does, and runs for qwen3)
PART_CASES = {
    "qwen3": {"arch": "qwen3-1.7b", "overrides": {}, "seq": 16, "meshed": True,
              "layouts": ("kv_head", "head_dim", "seq")},
    "qwen3_whole": {"arch": "qwen3-1.7b", "overrides": {"n_heads": 6, "n_kv_heads": 2},
                    "seq": 15},
    "dbrx": {"arch": "dbrx-132b", "overrides": {}, "seq": 16, "n_experts": N_EXPERTS["dbrx-132b"],
             "meshed": True},
    "whisper": {"arch": "whisper-medium", "overrides": {}, "seq": 16, "frames": 12},
    "jamba": {"arch": "jamba-v0.1-52b", "overrides": {"n_layers": N_LAYERS["jamba-v0.1-52b"]},
              "seq": 16, "n_experts": N_EXPERTS["jamba-v0.1-52b"], "meshed": True,
              "float64": True},
    "xlstm": {"arch": "xlstm-350m", "overrides": {"n_layers": 8}, "seq": 16, "float64": True},
}
PART_MESHES = ((2, 2), (1, 4))
PART_LAYOUTS = ("kv_head", "head_dim")
PART_STEPS, PART_MAX_LEN = 16, 32


def part_cfg(case: dict, get=get_config):
    """The case's reduced config (``get``: either package's
    ``get_config``); a ``float64`` case is f64 in the port alone."""
    cfg = get(case["arch"]).reduced(**case["overrides"])
    if case.get("float64") and get is get_config:
        cfg = replace(cfg, dtype="float64", param_dtype="float64")
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, n_experts=case["n_experts"],
                                       capacity_factor=CAPACITY))
    return cfg


def _partitioned_inputs(work: Path, rs, meshed: dict) -> dict:
    """Per case: JAX's params (bridged, saved leaf by leaf for the ranks),
    a batch of 4 rows, the unmeshed port's loss and gradients, eval loss,
    prefill logits and 16 greedy serve steps (their input tokens and
    lengths saved), and JAX's ``loss_fn`` and ``forward`` on the same
    inputs (a meshed case's, ``meshed``, where the case is its config)."""
    from repro.models import model as JM
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import transformer as T
    from repro_torch.tree import unflatten
    cases = {}
    refs = {}
    for name, case in PART_CASES.items():
        cfg_j, cfg = part_cfg(case, jget_config), part_cfg(case)
        if case.get("meshed"):
            assert part_cfg(case, jget_config) == meshed_cfg(case["arch"], jget_config)
            a = np.load(work / f"meshed_{case['arch']}.npz")
            params = map_like(lambda t, a_: t.to(a_.dtype),
                              unflatten(M.abstract_params(cfg), [torch.from_numpy(a[f"leaf{i}"])
                                                                 for i in range(int(a["n_leaves"]))]),
                              M.abstract_params(cfg))
            batch = {"tokens": a["tokens"], "labels": a["labels"]}
            jref = meshed[case["arch"]]
            jax_loss, jax_prefill = jref["jax_eval"], jref["jax_prefill"]
        else:
            jparams = JM.init_params(cfg_j, seed=3)
            params = map_like(lambda t, a: t.to(a.dtype),
                              params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"),
                              M.abstract_params(cfg))
            S = case["seq"]
            batch = {"tokens": rs.randint(4, cfg.vocab, (4, S)).astype(np.int32),
                     "labels": rs.randint(4, cfg.vocab, (4, S)).astype(np.int32)}
            batch["labels"][rs.rand(4, S) < 0.25] = -1
            if cfg.is_encdec:
                batch["frames"] = rs.standard_normal((4, case["frames"], cfg.d_model)
                                                     ).astype(np.float32)
            jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
            jax_loss = float(JT.loss_fn(jparams, jb, cfg_j))
            jax_prefill = np.asarray(JT.forward(jparams, {k: v for k, v in jb.items()
                                                          if k != "labels"}, cfg_j))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        fwd = {k: v for k, v in tb.items() if k != "labels"}
        loss, grads = M.loss_and_grads(params, tb, cfg)
        ref = {"loss": float(loss), "grads": [g.numpy() for g in leaves(grads)],
               "eval": float(M.make_eval_step(cfg)(params, tb)),
               "prefill": M.make_prefill_step(cfg)(params, fwd).numpy(),
               "jax_loss": jax_loss, "jax_prefill": jax_prefill}
        save = {f"leaf{i}": t.numpy() for i, t in enumerate(leaves(params))}
        save.update(n_leaves=len(save), **batch)
        extra = {}
        if cfg.is_encdec:
            with torch.inference_mode():
                save["enc_out"] = T._encode(params, tb["frames"], cfg).numpy()
            extra["enc_out"] = torch.from_numpy(save["enc_out"])
        serve, state = M.make_serve_step(cfg), T.init_decode_state(cfg, 4, PART_MAX_LEN, "cpu")
        toks = rs.randint(4, cfg.vocab, 4).astype(np.int32)
        lens = np.array([0, 3, 7, 1], np.int32)
        ins, outs, logits = [], [], []
        for _ in range(PART_STEPS):
            ins.append((toks, lens))
            tn, tl, state = serve(params, state, {"tokens": torch.from_numpy(toks),
                                                  "lengths": torch.from_numpy(lens), **extra})
            outs.append(tn.numpy())
            logits.append(tl.numpy())
            toks, lens = tn.numpy().astype(np.int32), lens + 1
        save["serve_tokens"] = np.stack([t for t, _ in ins])
        save["serve_lengths"] = np.stack([n for _, n in ins])
        ref["serve"] = (np.stack(outs), np.stack(logits))
        ref["caches"] = {key: t.numpy() for key, t, _ in _caches(state)}
        ref["states"] = {key: t.numpy() for key, t, _ in _recurrent(state)}
        ref["kinds"] = {f"slot{i}": kind for i, kind in enumerate(cfg.block_pattern)}
        # per recurrent layer (its kind, whether it carries a MoE FFN): the
        # bytes of its leaves that "model" cuts (but the sLSTM's w_h, read
        # whole), and of the others
        specs = M.spec_tree(cfg)["body"]
        ref["layer_split"] = {}
        for i, kind in enumerate(cfg.block_pattern):
            if kind in T.RECURRENT_KINDS:
                local = T._index(params["body"][f"slot{i}"], 0)
                cut = whole = 0
                for path, t, sp in _named(local, T._layer_specs(specs[f"slot{i}"], True)):
                    n = t.numel() * t.element_size()
                    if path[-1] != "w_h" and "model" in [a for e in sp if e
                                                         for a in ((e,) if isinstance(e, str) else e)]:
                        cut += n
                    else:
                        whole += n
                ref["layer_split"][kind, "moe" in local] = (cut, whole)
        # the bytes of one layer's leaves (the largest), of embed and of the head
        layers = [leaves(T._index(params["body"][slot], p)) for slot in params["body"]
                  for p in range(cfg.n_periods)]
        if cfg.is_encdec:
            layers += [leaves(T._index(params["enc_body"]["slot0"], p))
                       for p in range(cfg.n_enc_layers)]
        ref["layer_bytes"] = max(sum(t.numel() * t.element_size() for t in ls) for ls in layers)
        ref["head_bytes"] = max(params[k].numel() * params[k].element_size()
                                for k in ("embed", "lm_head") if k in params)
        ref["model_bytes"] = sum(t.numel() * t.element_size() for t in leaves(params))
        np.savez(work / f"part_{name}.npz", **save)
        cases[name] = dict(case, batch=sorted(batch), layouts=case.get("layouts", PART_LAYOUTS))
        refs[name] = ref
    (work / "partitioned.json").write_text(json.dumps({
        "cases": cases, "meshes": PART_MESHES, "steps": PART_STEPS,
        "max_len": PART_MAX_LEN, "capacity_factor": CAPACITY}))
    return refs


#: the vocab-parallel train step in float64: reduced qwen3 and dbrx (8
#: experts, a capacity that drops nothing) on (2, 2) and (1, 4), under both
#: remat policies, against the unmeshed step
V64_CASES = {"qwen3": "qwen3-1.7b", "dbrx": "dbrx-132b"}
V64_POLICIES = ("nothing", "dots")


def v64_cfg(arch: str):
    cfg = get_config(arch).reduced(dtype="float64", param_dtype="float64")
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, n_experts=N_EXPERTS[arch],
                                       capacity_factor=CAPACITY))
    return cfg


def _vocab64_inputs(work: Path, rs) -> dict:
    """Per case: f64 params (seeded, saved leaf by leaf for the ranks), a
    batch of 4 rows of 16 tokens with a quarter of the labels masked, and
    the unmeshed port's loss and gradients."""
    (work / "vocab64.json").write_text(json.dumps({
        "cases": V64_CASES, "meshes": PART_MESHES, "policies": V64_POLICIES,
        "n_experts": N_EXPERTS["dbrx-132b"], "capacity_factor": CAPACITY}))
    refs = {}
    for name, arch in V64_CASES.items():
        cfg = v64_cfg(arch)
        params = M.init_params(cfg, seed=5, device="cpu")
        batch = {"tokens": rs.randint(4, cfg.vocab, (4, 16)).astype(np.int32),
                 "labels": rs.randint(4, cfg.vocab, (4, 16)).astype(np.int32)}
        batch["labels"][rs.rand(4, 16) < 0.25] = -1
        loss, grads = M.loss_and_grads(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                       cfg)
        save = {f"leaf{i}": t.numpy() for i, t in enumerate(leaves(params))}
        np.savez(work / f"v64_{name}.npz", n_leaves=len(save), **save, **batch)
        refs[name] = {"loss": float(loss), "grads": [g.numpy() for g in leaves(grads)]}
    return refs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _moe_inputs(rs):
    cfg_j = jget_config("dbrx-132b").reduced()
    cfg_j = replace(cfg_j, moe=replace(cfg_j.moe, n_experts=8, capacity_factor=8.0))
    params, _ = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    p0 = jax.tree.map(lambda t: np.asarray(t[0], np.float32), params["body"]["slot0"]["moe"])
    x = rs.standard_normal((4, 16, cfg_j.d_model)).astype(np.float32)
    want = np.asarray(JMoE.moe_apply(jax.tree.map(jax.numpy.asarray, p0), jax.numpy.asarray(x),
                                     cfg_j, mesh=None))
    return p0, x, want


def _train_batches(rs, cfg):
    out = {}
    for i in range(2):
        tokens = rs.randint(4, cfg.vocab, (4, 32)).astype(np.int32)
        labels = rs.randint(4, cfg.vocab, (4, 32)).astype(np.int32)
        labels[rs.rand(4, 32) < 0.25] = -1
        out[f"tokens{i}"], out[f"labels{i}"] = tokens, labels
    return out


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Inputs made here from numpy seeds, the 4 ranks run once, and the
    inputs, the JAX and unmeshed references and each rank's results."""
    work = tmp_path_factory.mktemp("gloo")
    rs = np.random.RandomState(0)
    p0, x, moe_want = _moe_inputs(rs)
    c = rs.standard_normal(x.shape).astype(np.float32)
    np.savez(work / "moe.npz", x=x, c=c, **p0)
    ws = (rs.standard_normal((S, F, F)) * 0.3).astype(np.float32)
    xs = rs.standard_normal((MB, 5, F)).astype(np.float32)
    np.savez(work / "pipe.npz", ws=ws, xs=xs)
    qcfg = get_config("qwen3-1.7b").reduced(dtype="float64", param_dtype="float64")
    batches = _train_batches(rs, qcfg)
    np.savez(work / "train.npz", lr=np.float64(LR), **batches)
    meshed = _meshed_inputs(work, rs)
    partitioned = _partitioned_inputs(work, rs, meshed)
    vocab64 = _vocab64_inputs(work, rs)
    # the unmeshed step on the whole batch
    params = M.init_params(qcfg, seed=0, device="cpu")
    opt_cfg = AdamWConfig(lr=LR)
    opt = adamw_init(params, opt_cfg)
    step = M.make_train_step(qcfg, opt_cfg, total_steps=10)
    losses = []
    for i in range(2):
        batch = {k: torch.from_numpy(batches[f"{k}{i}"]) for k in ("tokens", "labels")}
        params, opt, aux = step(params, opt, batch)
        losses.append(float(aux["loss"]))
    # a checkpoint of params and int8 moments after one step (a vocabulary
    # of 1024 and an MLP of 256 x 512, so that the embedding and the MLP
    # have int8 moments, the MLP's with rows that "model" cuts)
    ccfg = get_config("qwen3-1.7b").reduced(vocab=1024, d_model=256, d_ff=512)
    q_cfg = AdamWConfig(lr=LR, state_dtype="int8")
    c_params = M.init_params(ccfg, seed=0, device="cpu")
    c_params, q_opt, _ = M.make_train_step(ccfg, q_cfg, total_steps=10)(
        c_params, adamw_init(c_params, q_cfg),
        {k: torch.from_numpy(batches[f"{k}0"]) for k in ("tokens", "labels")})
    ckpt = {"params": c_params, "opt": q_opt}
    CheckpointManager(work / "ckpt").save(7, ckpt)

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port), str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    deadline, logs = time.monotonic() + TIMEOUT_S, []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the 4 gloo ranks did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(log[-3000:] for log in logs)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(RANKS)]
    return {"ranks": ranks, "moe": (p0, x, c, moe_want), "pipe": (ws, xs),
            "train": (losses, params), "ckpt": (ccfg, ckpt), "qcfg": qcfg, "meshed": meshed,
            "partitioned": partitioned, "vocab64": vocab64}


def test_expert_parallel_moe_matches_jax_local_and_its_gradients(gloo):
    p0, x, c, want = gloo["moe"]
    cfg = get_config("dbrx-132b").reduced()
    cfg = replace(cfg, moe=replace(cfg.moe, n_experts=8, capacity_factor=8.0))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = MoE.moe_apply(tp, tx, cfg)                     # the port's local path
    np.testing.assert_allclose(y.detach().numpy(), want, atol=2e-4, rtol=0)
    (y * torch.from_numpy(c)).sum().backward()
    seen = set()
    for r in gloo["ranks"]:
        rows = r["moe_rows"]
        seen.update(rows.tolist())
        np.testing.assert_allclose(r["moe_y"], want[rows], atol=2e-4, rtol=0)
        np.testing.assert_allclose(r["moe_dx"], tx.grad.numpy()[rows], atol=2e-4, rtol=0)
        for k in ("router", "w_gate", "w_up", "w_down"):
            g = tp[k].grad.numpy()
            np.testing.assert_allclose(r["moe_d" + k], g, atol=2e-4 * np.abs(g).max(), rtol=0)
    assert seen == set(range(x.shape[0]))             # the batch split over "data"
    assert len({tuple(r["moe_rows"]) for r in gloo["ranks"]}) == 2


def test_pipeline_matches_sequential_stages(gloo):
    ws, xs = gloo["pipe"]
    want = torch.from_numpy(xs)
    for i in range(S):
        want = torch.tanh(want @ torch.from_numpy(ws[i]))
    for r in gloo["ranks"]:
        np.testing.assert_allclose(r["pipe"], want.numpy(), atol=1e-5, rtol=0)
        assert float(r["bubble"]) == pytest.approx((S - 1) / (MB + S - 1))


def _named(tree, specs, path=()):
    """(path, leaf, its spec) of every leaf of a dict tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], specs[k], path + (k,))
    else:
        yield path, tree, specs


def _flat_specs(tree, specs) -> list:
    """The spec of each leaf of ``tree``, in ``tree.leaves`` order (the
    specs are tuples, which ``leaves`` would walk into)."""
    out = []

    def walk(t, s):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], s[k])
        elif isinstance(t, list):
            for a, b in zip(t, s):
                walk(a, b)
        else:
            out.append(s)
    walk(tree, specs)
    return out


def test_sharded_train_step_matches_unmeshed_and_stores_shards(gloo):
    losses, params = gloo["train"]
    full = leaves(params)
    # each axis of the (2, 2) mesh that a leaf's spec names cuts it in two
    shards = [2 ** sum(e is not None for e in s)
              for s in _flat_specs(params, M.spec_tree(gloo["qcfg"]))]
    assert max(shards) == 4 and min(shards) == 1
    for r in gloo["ranks"]:
        # param_shardings: a placement per mesh axis; the production mesh
        # refuses a group of 4 ranks
        assert r["placements"].tolist() == ["(Replicate(), Shard(dim=0))",
                                            "(Shard(dim=1), Shard(dim=2))",
                                            "(Replicate(), Replicate())"]
        assert bool(r["production_refused"])
        np.testing.assert_allclose(r["train_losses"], losses, atol=1e-5, rtol=0)
        for i, t in enumerate(full):
            w = t.numpy()
            np.testing.assert_allclose(r[f"train_leaf{i}"], w, atol=1e-5 * np.abs(w).max(), rtol=0)
        assert r["train_numel"].tolist() == [t.numel() // n for t, n in zip(full, shards)]
    # the int8-moment step of the checkpoint's config against the unmeshed
    # one: each moment's row scale and every f32 moment within 1e-5 of its
    # largest, the int8 values within one step of rounding, and the params
    # within 3 lr (tests/torch_train_common.py's bound after AdamW steps: a
    # first step moves a weight by ~lr * g / (|g| + eps), so a gradient
    # within rounding of eps may move it by another share of lr)
    _, ckpt = gloo["ckpt"]
    n_params = len(leaves(ckpt["opt"]))           # "opt" sorts before "params"
    for r in gloo["ranks"]:
        for i, t in enumerate(leaves(ckpt)):
            w, got = t.numpy(), r[f"int8_leaf{i}"]
            if w.dtype == np.int8:
                assert np.abs(got.astype(np.int32) - w).max() <= 1
            elif i >= n_params:
                np.testing.assert_allclose(got, w, atol=3 * LR, rtol=0)
            else:
                np.testing.assert_allclose(got, w, atol=1e-5 * np.abs(w).max(), rtol=1e-5)


def _block(a: np.ndarray, spec: tuple, data: int, coord: int) -> np.ndarray:
    """The block of ``a`` that the rank at ``coord`` of a (data, 1) mesh holds."""
    idx = []
    for i, n in enumerate(a.shape):
        e = spec[i] if i < len(spec) else None
        idx.append(slice(coord * n // data, (coord + 1) * n // data) if e == "data"
                   else slice(None))
    return a[tuple(idx)]


def test_restore_elastic_gives_each_rank_its_block_bit_for_bit(gloo):
    ccfg, ckpt = gloo["ckpt"]
    specs = M.spec_tree(ccfg)
    pspecs = {"params": specs,
              "opt": M.opt_spec_tree(specs, AdamWConfig(state_dtype="int8"), ccfg)}
    flat_specs = _flat_specs(ckpt, pspecs)
    stored = [t.numpy() for t in leaves(ckpt)]
    assert any(t.dtype == np.int8 for t in stored)
    for rank, r in enumerate(gloo["ranks"]):
        assert int(r["r41_step"]) == 7
        for i, (a, s) in enumerate(zip(stored, flat_specs)):
            assert np.array_equal(r[f"r41_leaf{i}"], _block(a, s, 4, rank)), (rank, i, s)
    r0 = gloo["ranks"][0]
    assert int(r0["r11_step"]) == 7
    for i, a in enumerate(stored):
        assert np.array_equal(r0[f"r11_leaf{i}"], a)
    assert all("r11_step" not in r for r in gloo["ranks"][1:])


def test_train_launcher_meshes_over_the_process_group(tmp_path):
    """``launch.train --mesh host`` alone starts a one-rank gloo group and
    trains to the unmeshed run's losses; ``--mesh single`` refuses a
    group that is not 256 ranks."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")

    def run(*extra, name):
        return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                               "--reduced", "--steps", "3", "--checkpoint-dir",
                               str(tmp_path / name), *extra],
                              env=env, capture_output=True, text=True, timeout=120)
    plain, meshed = run(name="plain"), run("--mesh", "host", name="host")
    assert plain.returncode == meshed.returncode == 0, plain.stderr[-2000:] + meshed.stderr[-2000:]
    final = [line for line in plain.stdout.splitlines() if line.startswith("final loss")]
    assert final and final == [line for line in meshed.stdout.splitlines()
                               if line.startswith("final loss")]
    single = run("--mesh", "single", name="single")
    assert single.returncode != 0 and "needs 256 ranks" in single.stderr


F32_TOL = dict(atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("arch", MESHED)
def test_meshed_eval_and_prefill_match_unmeshed_and_jax(gloo, arch):
    """On (2, 2): every rank's eval loss is the global batch's, equal to the
    unmeshed port's within 1e-5 (the sharded train step's tolerance) and to
    JAX's ``loss_fn``; the prefill's rows, gathered over the ranks, equal
    the unmeshed logits and JAX's ``forward``."""
    ref = gloo["meshed"][arch]
    assert ref["eval"] == pytest.approx(ref["jax_eval"], abs=3e-5, rel=3e-5)
    np.testing.assert_allclose(ref["prefill"], ref["jax_prefill"], **F32_TOL)
    seen = set()
    for r in gloo["ranks"]:
        assert float(r[f"{arch}_eval"]) == pytest.approx(ref["eval"], abs=1e-5)
        assert float(r[f"{arch}_eval"]) == pytest.approx(ref["jax_eval"], abs=3e-5, rel=3e-5)
        rows = r[f"{arch}_prefill_rows"]
        seen.update(rows.tolist())
        np.testing.assert_allclose(r[f"{arch}_prefill"], ref["prefill"][rows], **F32_TOL)
        np.testing.assert_allclose(r[f"{arch}_prefill"], ref["jax_prefill"][rows], **F32_TOL)
    assert seen == set(range(4))


@pytest.mark.parametrize("arch,layout,B", [(a, lay, b) for a in MESHED for lay, b in SERVE_CASES[a]])
def test_meshed_serve_steps_match_unmeshed_and_jax(gloo, arch, layout, B):
    """8 greedy serve steps on (2, 2) from each rank's block of the decode
    state (``decode_state_specs`` under ``layout``): each rank's tokens
    equal the unmeshed port's and JAX's ``make_serve_step``'s at its rows
    exactly, its logits the unmeshed port's within the f32 tolerance."""
    jtoks, toks, logits = gloo["meshed"][arch][f"serve{B}"]
    assert np.array_equal(toks, jtoks)
    tag = f"{arch}_{layout}_{B}"
    for r in gloo["ranks"]:
        rows = r[tag + "_rows"]
        assert np.array_equal(r[tag + "_toks"], toks[:, rows])
        assert np.array_equal(r[tag + "_toks"], jtoks[:, rows])
        np.testing.assert_allclose(r[tag + "_logits"], logits[:, rows], **F32_TOL)


PART_IDS = [(name, shape) for name in PART_CASES for shape in PART_MESHES]


def _tag(name, shape):
    return f"{name}_{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("name,shape", PART_IDS, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_partitioned_train_step_matches_unmeshed(gloo, name, shape):
    """The partitioned ``loss_and_grads`` (each layer's leaves gathered on
    use, tensor-parallel attention and MLP, the sequence split over
    "model", remat): every rank's loss equals the unmeshed port's within
    1e-5, and its gradients, gathered from the ranks' shards, each leaf
    within 1e-5 of its largest."""
    ref, tag = gloo["partitioned"][name], _tag(name, shape)
    for r in gloo["ranks"]:
        assert float(r[tag + "_loss"]) == pytest.approx(ref["loss"], abs=1e-5)
        for i, g in enumerate(ref["grads"]):
            np.testing.assert_allclose(r[f"{tag}_grad{i}"], g, atol=1e-5 * np.abs(g).max(),
                                       rtol=0, err_msg=f"{tag} grad leaf {i}")


@pytest.mark.parametrize("name,shape", PART_IDS, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_partitioned_eval_and_prefill_match_unmeshed(gloo, name, shape):
    """The partitioned eval step's loss (the global batch's) within 1e-5 of
    the unmeshed port's; the prefill's rows, gathered over the ranks,
    within 1e-5 of the largest logit."""
    ref, tag = gloo["partitioned"][name], _tag(name, shape)
    scale = np.abs(ref["prefill"]).max()
    seen = set()
    for r in gloo["ranks"]:
        assert float(r[tag + "_eval"]) == pytest.approx(ref["eval"], abs=1e-5)
        rows = r[tag + "_rows"]
        seen.update(rows.tolist())
        np.testing.assert_allclose(r[tag + "_prefill"], ref["prefill"][rows], atol=1e-5 * scale,
                                   rtol=0)
    assert seen == set(range(4))


PART_SERVE = [(name, shape, layout) for name, shape in PART_IDS
              for layout in PART_CASES[name].get("layouts", PART_LAYOUTS)
              if layout != "kv_head" or part_cfg(PART_CASES[name]).n_kv_heads % shape[1] == 0]


@pytest.mark.parametrize("name,shape,layout", PART_SERVE,
                         ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_partitioned_serve_steps_match_unmeshed(gloo, name, shape, layout):
    """16 greedy serve steps of the partitioned serve step under each cache
    layout: each rank's tokens equal the unmeshed port's at its rows
    exactly, its logits within 1e-5 of the largest."""
    toks, logits = gloo["partitioned"][name]["serve"]
    tag = f"{_tag(name, shape)}_{layout}"
    for r in gloo["ranks"]:
        rows = r[_tag(name, shape) + "_rows"]
        assert np.array_equal(r[tag + "_toks"], toks[:, rows])
        np.testing.assert_allclose(r[tag + "_logits"], logits[:, rows],
                                   atol=1e-5 * np.abs(logits).max(), rtol=0)


@pytest.mark.parametrize("name", PART_CASES)
def test_unmeshed_port_matches_jax_on_the_partitioned_configs(gloo, name):
    ref = gloo["partitioned"][name]
    assert ref["loss"] == pytest.approx(ref["jax_loss"], abs=3e-5, rel=3e-5)
    assert ref["eval"] == pytest.approx(ref["jax_loss"], abs=3e-5, rel=3e-5)
    np.testing.assert_allclose(ref["prefill"], ref["jax_prefill"], **F32_TOL)


@pytest.mark.parametrize("name,shape", PART_IDS, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_no_gather_returns_more_than_one_layer(gloo, name, shape):
    """The bytes each ``sharding.gather`` call of the partitioned train and
    prefill steps returns: never more than one layer's leaves, or embed,
    or the head, and their sum a step's worth of layer-by-layer gathers
    (no whole-tree gather before the step)."""
    ref, tag = gloo["partitioned"][name], _tag(name, shape)
    bound = max(ref["layer_bytes"], ref["head_bytes"])
    assert bound < ref["model_bytes"] / 2
    for r in gloo["ranks"]:
        got = r[tag + "_gathered"]
        assert len(got) > 0 and got.max() <= bound, (got.max(), bound)


def _kv_local(name: str, shape) -> bool:
    """The kv_head layout keeps each rank's cache local: the config has an
    attention cache, its KV heads divide over "model" and its decode
    heads split (a local group size the decode kernel takes)."""
    from repro_torch.kernels.decode_attention import GROUPS
    from repro_torch.models.layers import head_split
    cfg = part_cfg(PART_CASES[name])
    return ("attn" in cfg.block_pattern and cfg.n_kv_heads % shape[1] == 0
            and head_split(cfg, shape[1], 0, GROUPS) is not None)


PART_KV = [(name, shape) for name, shape in PART_IDS if _kv_local(name, shape)]


@pytest.mark.parametrize("name,shape", PART_KV, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_kv_head_serve_step_moves_no_cache_bytes(gloo, name, shape):
    """A serve step's collective bytes (the dry run's ``Counter`` on the
    gloo ranks) at two cache lengths: the same under the kv_head layout,
    where each rank writes and reads its own KV heads, and more at the
    longer cache under head_dim, whose partial scores (B, H, S) are
    all-reduced."""
    tag = _tag(name, shape)
    for r in gloo["ranks"]:
        kv, hd = r[tag + "_kv_head_moved"], r[tag + "_head_dim_moved"]
        assert kv[0] > 0 and kv[0] == kv[1], kv
        assert hd[1] > hd[0] > kv[0], (hd, kv)


def _attn_layers(cfg) -> int:
    return sum(k == "attn" for k in cfg.block_pattern) * cfg.n_periods + cfg.n_dense_prefix


@pytest.mark.parametrize("name,shape", PART_IDS, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_head_dim_serve_cache_blocks_equal_the_unmeshed_cache(gloo, name, shape):
    """After 16 serve steps under the head_dim layout each rank's block of
    every attention cache (its rows over "data", its head_dim columns over
    "model") equals that block of the unmeshed cache: each rank wrote its
    own columns at each lane's length."""
    ref, tag = gloo["partitioned"][name], _tag(name, shape)
    for r in gloo["ranks"]:
        for key, whole in ref["caches"].items():
            at = tuple(slice(a, b) for a, b in r[f"{tag}_head_dim_{key}_at"])
            got = r[f"{tag}_head_dim_{key}"]
            assert got.shape == whole[at].shape and got.shape[-1] < whole.shape[-1]
            np.testing.assert_allclose(got, whole[at], atol=1e-5 * np.abs(whole).max(), rtol=0,
                                       err_msg=f"{tag} {key}")


@pytest.mark.parametrize("name,shape", PART_IDS, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_head_dim_serve_step_gathers_no_cache(gloo, name, shape):
    """A head_dim serve step's collective bytes (the dry run's ``Counter``
    on the gloo ranks) at a cache twice as long: the all-gathers (layer
    leaves, the queries' heads, the outputs' columns, the logits'
    vocabulary) move the same bytes, so no cache byte is gathered; the
    all-reduces grow by exactly the partial scores' growth, one f32 (B,
    H, S) a layer (f64 in a float64 case)."""
    cfg, tag = part_cfg(PART_CASES[name]), _tag(name, shape)
    score_bytes = 8 if cfg.dtype == "float64" else 4
    for r in gloo["ranks"]:
        (ag0, ar0), (ag1, ar1) = r[tag + "_head_dim_kinds"]
        rows = len(r[tag + "_rows"])
        assert ag0 == ag1 > 0, (ag0, ag1)
        assert ar1 - ar0 == _attn_layers(cfg) * rows * cfg.n_heads * PART_MAX_LEN * score_bytes, \
            (ar0, ar1)


#: the partitioned cases with recurrent blocks, on each mesh
PART_RECURRENT = [(name, shape) for name, shape in PART_IDS
                  if {"mamba", "mlstm", "slstm"} & set(part_cfg(PART_CASES[name]).block_pattern)]


@pytest.mark.parametrize("name,shape", PART_RECURRENT, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_recurrent_state_blocks_equal_the_unmeshed_state(gloo, name, shape):
    """After 16 serve steps each rank's block of every recurrent state (its
    rows over "data"; mamba's conv and h over their Din channels and the
    sLSTM's four states over D on "model") equals that block of the
    unmeshed state within 1e-5 of its largest: each rank stepped its own
    channels in place.  The mLSTM state, whole on every "model" rank as
    the reference keeps it, is equal bit for bit on the ranks that hold
    the same rows."""
    ref, tag = gloo["partitioned"][name], _tag(name, shape)
    assert ref["states"]
    for key, whole in ref["states"].items():
        cut = ref["kinds"][key.split("_")[0]] != "mlstm"
        by_rows = {}
        for r in gloo["ranks"]:
            at = tuple(slice(a, b) for a, b in r[f"{tag}_state_{key}_at"])
            got = r[f"{tag}_state_{key}"]
            assert got.shape == whole[at].shape, (key, got.shape)
            assert (got.size * shape[1] == whole[at[:2]].size) if cut else \
                (got.size == whole[at[:2]].size), key
            np.testing.assert_allclose(got, whole[at], atol=1e-5 * np.abs(whole).max(), rtol=0,
                                       err_msg=f"{tag} {key}")
            if not cut:
                first = by_rows.setdefault(tuple(r[tag + "_rows"]), got)
                assert np.array_equal(got, first), f"{tag} {key}: differs between ranks"


@pytest.mark.parametrize("name,shape", PART_RECURRENT, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_serve_step_gathers_no_recurrent_state(gloo, name, shape):
    """No ``sharding.gather`` call of the 16 serve steps, under either
    cache layout, takes a recurrent state: each rank decodes its own
    block in place."""
    tag = _tag(name, shape)
    for r in gloo["ranks"]:
        for layout in PART_CASES[name].get("layouts", PART_LAYOUTS):
            key = f"{tag}_{layout}_state_gathers"
            if key in r:
                assert int(r[key]) == 0, (key, int(r[key]))


@pytest.mark.parametrize("name,shape", PART_RECURRENT, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_recurrent_layer_gathers_hold_a_tp_share_of_its_cut_leaves(gloo, name, shape):
    """Every recurrent layer call of the train step (and its recompute),
    the prefill and the serve steps gathers at most 1/tp of the bytes of
    its leaves that "model" cuts, plus its leaves read whole (norms,
    ``w_bc``, ``w_if``, the biases, the sLSTM's ``w_h``): no cut leaf is
    gathered whole over "model"."""
    ref, tag = gloo["partitioned"][name], _tag(name, shape)
    kinds = ("mamba", "mlstm", "slstm")
    for r in gloo["ranks"]:
        calls = r[tag + "_layer_bytes"]
        seen = {kinds[k] for k in calls[:, 0]}
        assert seen == set(ref["kinds"].values()) & set(kinds), seen
        for k, moe, got in calls:
            cut, whole = ref["layer_split"][kinds[k], bool(moe)]
            assert cut > 0 and got <= cut // shape[1] + whole, (kinds[k], got, cut, whole)


@pytest.mark.parametrize("name,shape", PART_IDS, ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_meshed_logits_are_whole_over_the_vocabulary(gloo, name, shape):
    """The prefill step and the serve step return the rank's rows over the
    whole padded vocabulary, equal to the unmeshed logits within 1e-5 of
    the largest: the serve step's (and the prefill's on (2, 2), 32 rows
    under d_model 64) gathered from each rank's head columns, the
    prefill's on (1, 4) (64 rows) through the head gathered whole."""
    cfg, ref, tag = part_cfg(PART_CASES[name]), gloo["partitioned"][name], _tag(name, shape)
    _, logits = ref["serve"]
    for r in gloo["ranks"]:
        rows = r[tag + "_rows"]
        assert r[tag + "_prefill"].shape == (len(rows),) + ref["prefill"].shape[1:-1] + \
            (cfg.padded_vocab,)
        got = r[tag + "_head_dim_logits"]
        assert got.shape == (PART_STEPS, len(rows), cfg.padded_vocab)
        np.testing.assert_allclose(got, logits[:, rows], atol=1e-5 * np.abs(logits).max(), rtol=0)


V64_IDS = [(name, shape, policy) for name in V64_CASES for shape in PART_MESHES
           for policy in V64_POLICIES]


@pytest.mark.parametrize("name,shape,policy", V64_IDS,
                         ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_vocab_parallel_train_step_matches_unmeshed_in_f64(gloo, name, shape, policy):
    """The meshed ``loss_and_grads`` in float64 with the head and the cross
    entropy vocab-parallel over "model" (the embedding's rows and the
    head's columns never gathered) under each remat policy: every rank's
    loss equals the unmeshed port's (each "model" rank holds the whole
    sequence's terms; summing them over "model" would give tp times it),
    and its gradients, gathered from the shards, each leaf within 1e-6 of
    its largest (the logits are f32, as unmeshed)."""
    ref = gloo["vocab64"][name]
    tag = f"v64_{name}_{shape[0]}x{shape[1]}_{policy}"
    for r in gloo["ranks"]:
        assert float(r[tag + "_loss"]) == pytest.approx(ref["loss"], abs=1e-6, rel=0)
        for i, g in enumerate(ref["grads"]):
            np.testing.assert_allclose(r[f"{tag}_grad{i}"], g, atol=1e-6 * np.abs(g).max(),
                                       rtol=0, err_msg=f"{tag} grad leaf {i}")


@pytest.mark.parametrize("name,shape", [(n, s) for n in V64_CASES for s in PART_MESHES],
                         ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_dots_remat_policy_changes_no_number(gloo, name, shape):
    """``REPRO_REMAT_POLICY=dots`` (the products' outputs saved, the rest
    of each period recomputed) gives the meshed train step's loss and
    gradients bit for bit as the default "nothing" (all recomputed)."""
    tag = f"v64_{name}_{shape[0]}x{shape[1]}"
    for r in gloo["ranks"]:
        assert r[tag + "_dots_loss"] == r[tag + "_nothing_loss"]
        for i in range(len(gloo["vocab64"][name]["grads"])):
            assert np.array_equal(r[f"{tag}_dots_grad{i}"], r[f"{tag}_nothing_grad{i}"]), i

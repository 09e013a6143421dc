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
* the sharded train step of reduced qwen3 (B = 4, S = 32, f32, a quarter
  of the labels masked) on a (2, 2) mesh against the unmeshed step on the
  whole batch, 2 steps: the losses within 1e-5, every updated leaf within
  1e-5 of its largest, and each rank storing numel / shards of each leaf;
* ``restore_elastic`` of a checkpoint (f32 params and int8 AdamW moments)
  onto (4, 1) and (1, 1) meshes, each rank's blocks bit for bit the
  slices of the stored leaves (cut here independently of the port's
  slicer).

f32 throughout; the sums over ranks run in another order than the
unmeshed ones, hence the tolerances.
"""
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
from repro_torch.tree import leaves  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
RANKS = 4
TIMEOUT_S = 200          # the whole 4-rank run, start to finish
S, MB, F = 4, 6, 8       # pipeline: stages, microbatches, width
LR = 1e-3

_WORKER = r'''
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

# (c) the sharded train step of reduced qwen3 on (2, 2)
qcfg = get_config("qwen3-1.7b").reduced()
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

np.savez(work / f"rank{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print("RANK DONE", rank)
'''


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
    qcfg = get_config("qwen3-1.7b").reduced()
    batches = _train_batches(rs, qcfg)
    np.savez(work / "train.npz", lr=np.float64(LR), **batches)
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
            "train": (losses, params), "ckpt": (ccfg, ckpt), "qcfg": qcfg}


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
    # within 3 lr (tests/test_torch_train.py's bound after AdamW steps: a
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

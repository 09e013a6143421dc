"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its
counter on hand-computable programs, the kernels' shape and work rules,
the reference's skip rule, the two routes a cell can be traced by (the
plain versions on fake "cpu" tensors, the shape rules on tensors without
data) counting alike, the CLI over the fake 256-rank group, and the copy
of ``launch/hlo_walk.py`` against the reference's walk.

Process groups are started in subprocesses, or destroyed before the test
ends: other test files share this worker."""
import ast
import json
import os
import resource
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_walk as JHW  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import decode_split as DS  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import moe_router as MR  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_walk as HW  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


# ---------------------------------------------------------------------------
# the counter on hand-computable programs
# ---------------------------------------------------------------------------
def test_counter_counts_one_matmul_and_its_bytes():
    with _fake():
        x, w = torch.empty(64, 128), torch.empty(128, 32)
        c = D.Counter()
        with c.tracing():
            y = x @ w
    assert c.flops == 2 * 64 * 128 * 32
    assert c.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert c.ops["aten.mm"] == 1
    assert c.peak == 4 * 64 * 32 and y.shape == (64, 32)


def test_counter_counts_a_loop_of_layers_each_time_and_inference_mode_alike():
    """L layers of a Python loop count L times; under inference mode a
    matmul arrives whole and is counted by what it decomposes into."""
    L = 5
    counts = []
    for inference in (False, True):
        with _fake():
            x, w = torch.empty(4, 16, 32), torch.empty(32, 32)
            c = D.Counter()
            with c.tracing(), torch.inference_mode(inference):
                for _ in range(L):
                    x = torch.tanh(x @ w)
        counts.append((c.flops, c.bytes, c.ops["aten.mm"], c.ops["aten.tanh"]))
    assert counts[0] == counts[1]
    assert counts[0][0] == L * 2 * 64 * 32 * 32
    assert counts[0][2:] == (L, L)


def test_counter_peak_follows_freed_storages():
    """A temporary freed before the next is made counts once at the peak;
    the arguments (``hold``) count apart from it; a view makes nothing."""
    with _fake():
        x = torch.empty(1000)
        c = D.Counter()
        assert c.hold(x) == 4000
        with c.tracing():
            a = x * 2
            del a
            b = x * 3
            v = b[:10]
    assert c.peak == 4000 and c.live == 4000 and v.shape == (10,)
    assert c.ops["aten.slice"] == 1


def test_counter_holds_an_allocation_written_in_place():
    """A buffer made by ``empty`` and filled in place (a collective's
    output, a blockwise AdamW update's new leaf) is live memory from its
    allocation; the allocation moves no bytes, the fill its operands and
    result."""
    with _fake():
        x = torch.empty(1000)
        c = D.Counter()
        c.hold(x)
        with c.tracing():
            buf = torch.empty(1000)
            buf.copy_(x)
    assert c.peak == c.live == 4000
    assert c.bytes == 3 * 4000 and buf.shape == (1000,)   # operands and result


def test_counter_counts_the_checkpointed_recompute_and_frees_its_activations():
    """Two products under ``torch.utils.checkpoint`` (non-reentrant, as a
    meshed train step's periods run): their forward, the recompute in the
    backward (the first product alone: the recompute stops once the last
    tensor the backward reads, the tanh's output, is made again) and the
    backward's four products, 7 in all against 6 without the checkpoint;
    between forward and backward only the output is live with the
    checkpoint, the intermediates too without it."""
    from torch.utils.checkpoint import checkpoint
    mm = 2 * 64 * 128 * 128
    runs = {}
    for remat in (True, False):
        with _fake():
            x = torch.empty(64, 128, requires_grad=True)
            w = torch.empty(128, 128, requires_grad=True)
            c = D.Counter()
            c.hold((x, w))

            def f(x):
                return torch.tanh(x @ w) @ w
            with c.tracing():
                y = checkpoint(f, x, use_reentrant=False, preserve_rng_state=False) if remat \
                    else f(x)
                live = c.live
                y.sum().backward()
        runs[remat] = (c.flops, live)
    assert runs[True][0] == 7 * mm and runs[False][0] == 6 * mm
    assert runs[True][1] == 4 * 64 * 128 < runs[False][1]


def test_counter_records_a_gather_over_a_16_rank_fake_group():
    """An all-gather of a (4, 8) f32 shard over 16 fake ranks: one
    collective whose result is (64, 8), 2048 bytes."""
    import torch.distributed as dist
    D.start_fake_group(16)
    try:
        with pytest.raises(RuntimeError, match="exists already"):
            D.start_fake_group(16)
        from repro_torch.distributed.sharding import gather
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("data",))
        with _fake():
            shard = torch.empty(4, 8)
            c = D.Counter()
            with c.tracing():
                full = gather(shard, ("data", None), mesh)
    finally:
        dist.destroy_process_group()
    assert full.shape == (64, 8)
    assert c.collectives == {"all-gather": {"count": 1, "bytes": 64 * 8 * 4}}


# ---------------------------------------------------------------------------
# the kernels' shape and work rules
# ---------------------------------------------------------------------------
def _same(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert (tuple(g.shape), g.dtype, g.device) == (tuple(w.shape), w.dtype, w.device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_shape_rules_equal_the_plain_versions(dtype):
    """Each kernel's ``*_abstract`` rule gives its plain version's output
    shapes, dtypes and device on real CPU tensors, building nothing and
    launching nothing; each work rule's bytes are its operands' and
    results' bytes, its FLOPs the products' over the whole rectangle."""
    from repro_torch.kernels import build
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(dt)
    before = dict(ops.LAUNCHES)
    B, Hq, Hkv, Sq, Skv, Dh = 2, 4, 2, 8, 12, 16
    q, k, v = r(B, Hq, Sq, Dh), r(B, Hkv, Skv, Dh), r(B, Hkv, Skv, Dh)
    o, lse = ref.attention_ref(q, k, v, causal=True, return_lse=True)
    for with_lse in (False, True):
        _same(FA.flash_attention_abstract(q, k, v, with_lse=with_lse),
              ref.attention_ref(q, k, v, return_lse=with_lse))
    do = r(B, Hq, Sq, Dh)
    _same(FA.flash_attention_bwd_abstract(q, k, v, o, lse, do),
          ref.attention_bwd_ref(q, k, v, o, lse, do))
    x, s = r(3, 5, 64), r(64)
    for scale in (s, None):
        _same(RN.rmsnorm_abstract(x, scale), ref.rmsnorm_ref(x, scale))
        _same(RN.rmsnorm_bwd_abstract(x, scale, x), ref.rmsnorm_bwd_ref(x, scale, x))
    qd, kc, vc = r(B, Hq, Dh), r(B, Hkv, 32, Dh), r(B, Hkv, 32, Dh)
    lengths = torch.tensor([3, 32], dtype=torch.int32)
    _same(DA.decode_attention_abstract(qd, kc, vc, lengths),
          ref.decode_attention_ref(qd, kc, vc, lengths))
    logits = r(7, 16, dt=torch.float32)
    for renorm in (True, False):
        w, idx = ref.moe_router_ref(logits, 4, renormalize=renorm)
        _same(MR.moe_router_abstract(logits, 4, renormalize=renorm), (w, idx))
        _same(MR.moe_router_bwd_abstract(None if renorm else logits, w, idx, w,
                                         renormalize=renorm, n_experts=16),
              ref.moe_router_bwd_ref(logits, w, idx, w, renormalize=renorm))
    assert dict(ops.LAUNCHES) == before and not build._LIBS
    # the work rules: bytes in and out once, the products' FLOPs
    e = q.element_size()
    assert FA.flash_attention_work(q, k, v) == (2 * 2.0 * B * Hq * Sq * Skv * Dh,
                                                e * (2 * q.numel() + 2 * k.numel()))
    assert FA.flash_attention_bwd_work(q, k, v, o, lse, do)[0] == 5 * 2.0 * B * Hq * Sq * Skv * Dh
    assert DA.decode_attention_work(qd, kc, vc, lengths) == (
        4.0 * B * Hq * 32 * Dh, e * (2 * qd.numel() + 2 * kc.numel()) + 4 * B)
    assert RN.rmsnorm_work(x, s) == (0.0, e * (2 * x.numel() + 64))
    assert MR.moe_router_work(logits, 4) == (0.0, 4 * 7 * 16 + 8 * 7 * 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_decode_rules_equal_the_plain_versions(dtype):
    """``decode_scores``' and ``decode_combine``'s shape rules give their
    plain versions' shapes, dtypes and device (f32 scores, the output in
    the cache's dtype), with no build and no launch, and refuse what the
    kernels lack (a group of 32, a slice wider than 128 columns, bf16
    scores); their work rules count the products over the padded cache
    and each operand and result once."""
    from repro_torch.kernels import build
    g = torch.Generator().manual_seed(1)
    B, Hq, Hkv, S, Dl = 2, 12, 2, 40, 7
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((B, Hq, Dl), (B, Hkv, S, Dl), (B, Hkv, S, Dl)))
    lengths = torch.tensor([3, 40], dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    s = ref.decode_scores_ref(q, k, lengths, sm_scale=0.1)
    _same(DS.decode_scores_abstract(q, k, lengths, sm_scale=0.1), s)
    _same(DS.decode_combine_abstract(s, v, lengths), ref.decode_combine_ref(s, v, lengths))
    assert s.dtype == torch.float32
    assert dict(ops.LAUNCHES) == before and not build._LIBS
    e = q.element_size()
    assert DS.decode_scores_work(q, k, lengths, sm_scale=0.1) == (
        2.0 * B * Hq * S * Dl, e * (q.numel() + k.numel()) + 4 * B + 4 * B * Hq * S)
    assert DS.decode_combine_work(s, v, lengths) == (
        2.0 * B * Hq * S * Dl, 4 * s.numel() + e * v.numel() + 4 * B + e * B * Hq * Dl)
    with pytest.raises(ValueError, match="unsupported"):
        DS.decode_scores_abstract(torch.empty(1, 32, 8), torch.empty(1, 1, 4, 8),
                                  torch.ones(1, dtype=torch.int32), sm_scale=1.0)
    with pytest.raises(ValueError, match="unsupported"):
        DS.decode_combine_abstract(torch.empty(1, 2, 4), torch.empty(1, 1, 4, 129),
                                   torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32 scores"):
        DS.decode_combine_abstract(s.to(torch.bfloat16), v, lengths)


def test_kernel_entries_take_meta_tensors_to_their_shape_rules():
    """``kernels.ops`` on meta tensors: the shape rules, no launch; under
    grad the autograd Functions carry the rules to the backward."""
    before = dict(ops.LAUNCHES)
    q = torch.empty(1, 4, 8, 16, device="meta", requires_grad=True)
    kv = torch.empty(1, 2, 8, 16, device="meta", requires_grad=True)
    o = ops.attention(q, kv, kv)
    x = torch.empty(8, 64, device="meta", requires_grad=True)
    y = ops.rmsnorm(x, torch.empty(64, device="meta"))
    (o.sum() + y.sum()).backward()
    assert o.shape == q.shape and y.shape == x.shape
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape and x.grad.shape == x.shape
    w, idx = ops.moe_router(torch.empty(5, 16, device="meta"), 2)
    assert (w.shape, idx.dtype) == ((5, 2), torch.int32)
    assert dict(ops.LAUNCHES) == before


def test_the_two_routes_count_a_cell_alike(monkeypatch):
    """A reduced cell traced through the plain versions (fake "cpu") and
    through the shape rules (the card's route, taken here by sending the
    fake CPU tensors past ``_on_cpu``) gives the same cost, collectives
    and memory: train (every forward and backward rule), prefill and
    decode, on a (2, 2) fake mesh."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    D.start_fake_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for arch, kind in (("dbrx-132b", "train"), ("qwen3-1.7b", "prefill"),
                           ("qwen3-1.7b", "decode")):
            cfg = get_config(arch).reduced()
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8))
            shape = M.ShapeSpec(kind, 64, 4, kind)
            plain = D.trace_cell(cfg, shape, mesh, "cpu")
            with monkeypatch.context() as m:
                m.setattr(ops, "_on_cpu", lambda t: False)
                rules = D.trace_cell(cfg, shape, mesh, "cpu")
            for key in ("cost", "collectives", "memory"):
                assert plain[key] == rules[key], (arch, kind, key)
            kernels = {"rmsnorm", "decode_attention" if kind == "decode" else "flash_attention"}
            if kind == "train":
                kernels |= {"flash_attention_bwd", "rmsnorm_bwd", "moe_router", "moe_router_bwd"}
            assert kernels <= set(plain["ops"]) and plain["ops"] == rules["ops"]
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's rules
# ---------------------------------------------------------------------------
def _reference_functions(*names) -> dict:
    """The reference dry run's functions ``names``, from its source (its
    module sets XLA_FLAGS for 512 devices when imported, which would reach
    every JAX test of this process)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text(encoding="utf-8")
    defs = [n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"ModelConfig": object, "M": M, "AdamWConfig": AdamWConfig}
    exec(compile(ast.Module(body=defs, type_ignores=[]), "reference dryrun", "exec"), ns)
    return ns


def test_skip_reason_and_opt_cfg_are_the_references():
    refs = _reference_functions("skip_reason", "_opt_cfg")
    for arch in all_arch_ids():
        cfg = get_config(arch)
        assert D._opt_cfg(cfg) == refs["_opt_cfg"](cfg), arch
        for shape in M.SHAPES.values():
            assert D.skip_reason(cfg, shape) == refs["skip_reason"](cfg, shape), (arch, shape)


# ---------------------------------------------------------------------------
# the CLI over the fake 256-rank group
# ---------------------------------------------------------------------------
CLI_CELLS = (("qwen3-1.7b", "decode_32k"), ("dbrx-132b", "train_4k"), ("qwen3-1.7b", "train_4k"))
REF_ROOFLINE = ("chips", "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "model_flops_total", "model_flops_per_chip", "useful_flops_ratio")


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The three cells through ``python -m repro_torch.launch.dryrun
    --device cpu --mesh single``, in processes of their own started
    together; each cell's JSON, output and exit code, and the largest
    resident set of the three."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0], "--shape",
         cell[1], "--mesh", "single", "--device", "cpu", "--out-dir", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cell in CLI_CELLS}
    runs = {}
    try:
        for cell, p in procs.items():
            log = p.communicate(timeout=240)[0]
            runs[cell] = (p.returncode, log,
                          json.loads((out / f"{cell[0]}__{cell[1]}__16x16.json").read_text()))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return runs, resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss


@pytest.mark.parametrize("cell", CLI_CELLS[:2], ids=lambda c: "-".join(c))
def test_cli_cell_ends_ok_with_the_reference_keys(cli, cell):
    runs, max_rss_kb = cli
    rc, log, res = runs[cell]
    assert rc == 0, log[-3000:]
    assert log.strip().splitlines()[-1] == "DRYRUN SUMMARY ok=1 skip=0 error=0"
    assert res["status"] == "ok" and res["skip_reason"] is None and res["device"] == "cpu"
    assert set(REF_ROOFLINE) <= set(res["roofline"]) and res["roofline"]["chips"] == 256
    assert res["cost"]["flops"] > 0 and res["cost"]["bytes accessed"] > 0
    assert res["collectives"]["total_bytes"] > 0 and "all-gather" in res["collectives"]
    mem = res["memory"]
    assert mem["total_per_device"] == mem["argument_size_in_bytes"] + mem["peak_live_size_in_bytes"]
    assert res["trace_s"] > 0 and res["ops"]
    # full width and nothing allocated: each process (the largest resident
    # set of the three) stayed far below the bytes the largest rank would
    # hold (449 GiB for the train cell) and under 4 GiB; the decode cell's
    # rank, its embedding and head cut over the vocabulary, holds 1.8 GiB,
    # less than a process that has imported torch and traced a train step
    largest = max(r[2]["memory"]["total_per_device"] for r in runs.values())
    assert max_rss_kb * 1024 < min(4 << 30, largest)


def test_dense_compute_repeats_over_the_model_axis(cli):
    """qwen3-1.7b's train_4k on 16x16: the partitioned step splits the
    dense compute over "model" (tensor-parallel attention and MLP, the
    loss on each rank's sequence shard), so the 16 "model" ranks no longer
    repeat each other's compute: the useful share of the counted FLOPs is
    at least 0.25 (the remat's second forward and attention's full
    rectangles keep it below 3/4; ~0.59 is the prediction), where gathering
    the whole model held it at 1/16 or less.  Each layer's leaves are
    gathered on use: a rank holds its shards, one layer whole and the
    activations of its 16 rows, under an 80 GiB card (~4.7 GiB predicted,
    where the whole model gathered held 274 GiB)."""
    rc, log, res = cli[0][("qwen3-1.7b", "train_4k")]
    assert rc == 0, log[-3000:]
    ratio = res["roofline"]["useful_flops_ratio"]
    assert 0.25 <= ratio < 0.75
    assert res["memory"]["total_per_device"] < 80 * 2**30


#: a reduced qwen3 whose widths divide over 16 "model" ranks, 8 layers
SMALL_16 = dict(n_layers=8, d_model=256, n_heads=16, n_kv_heads=16, d_head=16, d_ff=1024,
                vocab=1024, dtype="bfloat16", param_dtype="bfloat16")


def test_partitioned_cells_hold_one_layer_at_a_time_on_16x16():
    """A reduced qwen3 (8 layers) traced on a fake 16x16 group: the train
    step (B = 16, S = 256) and the decode step (B = 16, a cache of 4096,
    the kv_head layout).  Per rank, ``total_per_device`` stays below two
    layers' bytes for the train step (its shards, a layer's block gathered
    on use and dropped after it, the tied embedding whole for the lookup
    and the head and their gradients; the whole model is 8 layers and the
    embedding), and below one layer, the embedding and the arguments (its
    cache) for the decode step; and the
    collective bytes of a step below a stated multiple of one layer's:
    6 for the train step (the forward's and the recompute's gathers of a
    layer's block over "data" and the sequence's gathers and scatters),
    and 2 for the decode step (each layer's block and the embedding, whole
    for the lookup and again as the tied head), which moves no cache byte:
    its collectives are the same at a cache twice as long."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.tree import leaves
    cfg = get_config("qwen3-1.7b").reduced(**SMALL_16)
    tree = M.abstract_params(cfg)
    layer = sum(t[0].numel() * t.element_size() for t in leaves(tree["body"]))
    embed = tree["embed"].numel() * tree["embed"].element_size()
    D.start_fake_group(256)
    try:
        mesh = make_production_mesh()
        train = D.trace_cell(cfg, M.ShapeSpec("t", 256, 16, "train"), mesh, "cpu")
        dec = D.trace_cell(cfg, M.ShapeSpec("d", 4096, 16, "decode"), mesh, "cpu")
        longer = D.trace_cell(cfg, M.ShapeSpec("d", 8192, 16, "decode"), mesh, "cpu")
    finally:
        dist.destroy_process_group()
    assert train["memory"]["total_per_device"] < 2 * layer
    assert train["collectives"]["total_bytes"] < 6 * layer
    assert dec["memory"]["total_per_device"] < layer + embed + \
        dec["memory"]["argument_size_in_bytes"]
    assert 0 < dec["collectives"]["total_bytes"] < 2 * layer
    assert dec["collectives"] == longer["collectives"]


def _smoke_limits() -> dict:
    """``chip_smoke.DRYRUN_LIMITS`` (the script imports only the standard
    library at its top)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.DRYRUN_LIMITS


RECURRENT_CELLS = (("jamba-v0.1-52b", "decode_32k"), ("xlstm-350m", "decode_32k"))


def test_recurrent_decode_cells_keep_the_smoke_limits(tmp_path):
    """jamba-v0.1-52b's and xlstm-350m's decode_32k through the CLI on fake
    CPU tensors (16x16), in processes of their own started together: each
    ends ok, within the smoke's ``DRYRUN_LIMITS`` for it: its collective
    bytes a step and its bytes a card, now that each mamba, mLSTM and
    sLSTM layer gathers only its 1/16 of the leaves "model" cuts, and no
    recurrent state moves; the channel takes are all-to-alls."""
    limits = _smoke_limits()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0], "--shape",
         cell[1], "--mesh", "single", "--device", "cpu", "--out-dir", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cell in RECURRENT_CELLS}
    try:
        logs = {cell: p.communicate(timeout=240)[0] for cell, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for (arch, shape), p in procs.items():
        assert p.returncode == 0, logs[arch, shape][-3000:]
        res = json.loads((tmp_path / f"{arch}__{shape}__16x16.json").read_text())
        lim = limits[arch, shape]
        assert res["status"] == "ok"
        assert 0 < res["collectives"]["total_bytes"] <= lim["collective"], res["collectives"]
        assert res["collectives"]["all-to-all"]["count"] > 0
        assert res["memory"]["total_per_device"] / 2**30 < lim["gib"], res["memory"]


# ---------------------------------------------------------------------------
# the copy of launch/hlo_walk.py
# ---------------------------------------------------------------------------
def test_hlo_walk_copy_walks_a_scan_as_the_reference_does():
    x = jax.ShapeDtypeStruct((64, 128), jnp.float32)
    w = jax.ShapeDtypeStruct((128, 128), jnp.float32)

    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        out, _ = jax.lax.scan(body, x, None, length=6)
        return out.sum()

    text = jax.jit(f).lower(x, w).compile().as_text()
    got, want = HW.walk(text), JHW.walk(text)
    assert got.as_dict() == want.as_dict()
    assert got.flops == 6 * 2 * 64 * 128 * 128 and 6 in got.while_trips


def test_cli_on_cuda_needs_a_cuda_build():
    """The default device is fake "cuda"; a CPU-only PyTorch cannot make
    one, so the CLI refuses it and names ``--device cpu``."""
    if torch.backends.cuda.is_built():
        pytest.skip("PyTorch is built with CUDA here: fake CUDA tensors can be made")
    with pytest.raises(RuntimeError, match="--device cpu"):
        D.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--mesh", "single"])


def test_head_dim_decode_moves_a_tenth_of_the_cache_on_16x16():
    """A reduced qwen3 with 8 KV heads of 64 dims (the head_dim layout at
    16 "model" ranks, 4 columns a rank) decoding B = 256 over a cache of
    4096 on a fake 16x16 group: its collective bytes are under a tenth of
    the cache bytes that gathering each layer's K and V over "model" (the
    layout's decode before the split kernels) would return, and its
    all-reduces hold the partial scores, one f32 (B, H, S) a layer, each
    layer calling decode_scores and decode_combine once."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config("qwen3-1.7b").reduced(**dict(SMALL_16, n_kv_heads=8, d_head=64))
    B, S = 256, 4096
    D.start_fake_group(256)
    try:
        dec = D.trace_cell(cfg, M.ShapeSpec("d", S, B, "decode"), make_production_mesh(), "cpu")
    finally:
        dist.destroy_process_group()
    rows = B // 16
    cache_gather = cfg.n_layers * 2 * rows * cfg.n_kv_heads * S * cfg.head_dim * 2
    assert dec["collectives"]["total_bytes"] < cache_gather / 10
    assert dec["collectives"]["all-reduce"]["bytes"] >= cfg.n_layers * rows * cfg.n_heads * S * 4
    kernels = {k: n for k, n in dec["ops"].items() if k in ("decode_scores", "decode_combine",
                                                            "decode_attention")}
    assert kernels == {"decode_scores": cfg.n_layers, "decode_combine": cfg.n_layers}, kernels

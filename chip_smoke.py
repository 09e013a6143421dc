#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout and drives
its main path on the card, printing one JSON line per phase:

  1. environment: torch/CUDA versions, the card, the kernel build;
  2. the serving LM's kernels (rmsnorm, decode_attention) against their
     plain PyTorch versions at the serving shapes, timed;
  3. a synthetic wiki of 16 x 256 x 256 = 2^20 files (~1.05M paths) in a
     DeviceEngine on the card and a HostEngine over the same PathStore;
  4. the storage kernels (path_lookup, prefix_search) against their plain
     versions on that engine's own tensors, timed;
  5. BatchPlanner waves of 4096 Q1, 1024 Q2, 1024 Q3, 64 Q4 and 256 Q4C
     ops, equal to the HostEngine's answers, then a write wave of 64
     admits whose refresh must patch, then the waves again;
  6. the wikikv-router serving loop at full width over the AuthTrace wiki
     on the card, against the same run on the CPU (plain versions);
  7. one JSON line of every kernel with its launches, error, times and
     bound; the card's name and power limit; the final ``{"ok": true, ...}``.

Every check that fails raises, and the script then exits non-zero with no
final line.  It needs a card (it exits non-zero when CUDA is not
available) and the rest of the checkout (it exits non-zero when run from
a directory that holds only this file).  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
INT8_OPS = 1979e12
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

SCALE_LOG2 = 20            # 2^20 files in the synthetic wiki
N_DIMS, N_TOPICS = 16, 256


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """Least time for the work (ms): the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    if got.dtype.is_floating_point:
        return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    return float((got.cpu() != want.cpu()).sum())


# ---------------------------------------------------------------------------
# phase 2 / 4: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_float(name, got, want, dtype) -> float:
    import torch
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    ok = torch.allclose(got.float(), want.float(), **tol)
    err = max_err(got, want)
    check(ok, f"{name}: kernel and plain version disagree (max abs err {err})")
    return err


def model_kernels(dev) -> dict:
    """rmsnorm and decode_attention at the serving shapes (batch 4 lanes,
    wikikv-router: 4 query heads, 2 KV heads, head_dim 64, d_model 256,
    max_len 512) and the longer-cache shapes; returns the JSON entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device="cpu").manual_seed(0)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rows, D in ((16, 64), (8, 64), (4, 256), (32, 64), (8, 256)):
            x = torch.randn((rows, D), generator=g).to(dev, dtype)
            s = torch.randn((D,), generator=g).to(dev, dtype)
            for scale in (s, None):
                got = ops.rmsnorm(x, scale)
                err = check_float(f"rmsnorm {rows}x{D}", got, ref.rmsnorm_ref(x, scale), dtype)
            if (rows, D) == (4, 256) and dtype == torch.float32:
                elt = x.element_size()
                b, by = bound(2 * rows * D * elt + D * elt, 4 * rows * D, F32_FLOPS)
                entries["rmsnorm"] = {
                    "name": "rmsnorm", "route": "triton",
                    "source": "src/repro_torch/kernels/rmsnorm.py",
                    "replaces": "src/repro/kernels/rmsnorm.py:37",
                    "shape": f"x ({rows}, {D}) float32 with scale",
                    "max_abs_err": err,
                    "ms": cuda_ms(lambda: rn.rmsnorm(x, s)),
                    "plain_ms": cuda_ms(lambda: ref.rmsnorm_ref(x, s)),
                    "library_ms": (cuda_ms(lambda: F.rms_norm(x, (D,), s, eps=1e-6))
                                   if hasattr(F, "rms_norm") else None),
                    "bound_ms": b, "bound_by": by}
    emit({"phase": "model_kernels", "rmsnorm": "ok",
          "rmsnorm_ms": entries["rmsnorm"]["ms"]})

    timings = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, lens in ((4, 512, [1, 97, 311, 512]),
                           (8, 512, [1, 7, 64, 129, 256, 300, 511, 512]),
                           (8, 4096, [1, 100, 1000, 2049, 3000, 4000, 4095, 4096])):
            Hq, Hkv, D = 4, 2, 64
            q = torch.randn((B, Hq, D), generator=g).to(dev, dtype)
            k = torch.randn((B, Hkv, S, D), generator=g).to(dev, dtype)
            v = torch.randn((B, Hkv, S, D), generator=g).to(dev, dtype)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = ops.decode_attention(q, k, v, ln)
            want = ref.decode_attention_ref(q, k, v, ln)
            err = check_float(f"decode_attention B={B} S={S}", got, want, dtype)
            ms = cuda_ms(lambda: da.decode_attention(q, k, v, ln))
            timings.append({"B": B, "S": S, "dtype": str(dtype), "ms": ms, "err": err})
            if (B, S) == (4, 512) and dtype == torch.float32:
                live = sum(lens)
                elt = q.element_size()
                b, by = bound(2 * Hkv * D * elt * live + 2 * B * Hq * D * elt + 4 * B,
                              4.0 * Hq * D * live, F32_FLOPS)
                # the yardstick: one SDPA call over the group-expanded
                # cache with the length mask (expanded outside the timing)
                mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[:, None, None, :]
                kx, vx = k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1)
                entries["decode_attention"] = {
                    "name": "decode_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "replaces": "src/repro/kernels/decode_attention.py:74",
                    "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} lengths={lens} float32",
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": cuda_ms(lambda: ref.decode_attention_ref(q, k, v, ln)),
                    "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                        q[:, :, None, :], kx, vx, attn_mask=mask)),
                    "bound_ms": b, "bound_by": by}
    emit({"phase": "model_kernels", "decode_attention": "ok", "times": timings})
    return entries


def storage_kernels(dev, eng, q1_paths, q4_prefixes) -> dict:
    """path_lookup and prefix_search on the DeviceEngine's own tensors
    (the sorted digest view with its pinned staging, the token matrix)
    with the query batches of the waves."""
    import numpy as np
    import torch
    from repro_torch.core import tensorstore as TS
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import path_lookup as pl
    from repro_torch.kernels import prefix_search as ps
    st = eng.epoch_view()
    dig = eng._digests(eng._norm(q1_paths))
    queries = torch.from_numpy(ops.key64(dig[:, 0], dig[:, 1])).to(dev)
    keys, pinned = st.keys, st.pinned
    got = ops.path_lookup(keys, queries, pinned=pinned)
    want = ref.path_lookup_pinned_ref(keys, queries, *pinned)
    check(torch.equal(got, want), "path_lookup (pinned) disagrees with its plain version")
    got_np = ops.path_lookup(keys, queries)
    check(torch.equal(got_np, ref.path_lookup_ref(keys, queries)),
          "path_lookup (no pinning) disagrees with its plain version")
    check(torch.equal(got, got_np), "pinned staging changed an answer")
    n_pin_hit = int(torch.isin(queries, pinned[0]).sum())
    Q, N, P = queries.numel(), keys.numel(), pinned[0].numel()
    b, by = bound(Q * 8 + Q * 4 + P * 12 + min(N, Q - n_pin_hit) * 8,
                  Q * (P + 128 + 96), INT8_OPS)
    lookup = {
        "name": "path_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/path_lookup.cu",
        "replaces": "src/repro/kernels/path_lookup.py:99",
        "shape": f"keys N={N} int64, Q={Q}, pinned P={P} ({n_pin_hit} pinned hits)",
        "max_abs_err": max_err(got, want),
        "ms": cuda_ms(lambda: pl.path_lookup(keys, queries, pinned=pinned)),
        "plain_ms": cuda_ms(lambda: ref.path_lookup_pinned_ref(keys, queries, *pinned)),
        "library_ms": cuda_ms(lambda: torch.searchsorted(keys, queries)),
        "bound_ms": b, "bound_by": by}

    L = st.ptoks.shape[1]
    pref = np.full((len(q4_prefixes), L), 255, dtype=np.uint8)
    lens = np.zeros((len(q4_prefixes),), dtype=np.int32)
    for i, p in enumerate(q4_prefixes):
        pref[i] = TS.pack_path(p, L)
        lens[i] = len(p.encode())
    pt, lt = torch.from_numpy(pref).to(dev), torch.from_numpy(lens).to(dev)
    toks = st.ptoks
    got = ops.prefix_search(toks, pt, lt)
    want = ref.prefix_search_ref(toks, pt, lt)
    check(torch.equal(got, want), "prefix_search disagrees with its plain version")
    check(int(got.sum()) > 0, "prefix_search found no match at all")
    Nr, Qp = toks.shape[0], pt.shape[0]
    b, by = bound(Nr * L + Qp * L + Qp * 4 + Nr * Qp, Nr * Qp * L, INT8_OPS)
    prefix = {
        "name": "prefix_search", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefix_search.cu",
        "replaces": "src/repro/kernels/prefix_search.py:52",
        "shape": f"tokens ({Nr}, {L}) uint8, Q={Qp} prefixes",
        "max_abs_err": max_err(got, want),
        "ms": cuda_ms(lambda: ps.prefix_search(toks, pt, lt)),
        "plain_ms": cuda_ms(lambda: ref.prefix_search_ref(toks, pt, lt), iters=5),
        "library_ms": None,
        "bound_ms": b, "bound_by": by}
    emit({"phase": "storage_kernels", "path_lookup_ms": lookup["ms"],
          "prefix_search_ms": prefix["ms"], "path_lookup_hits": int((got_np >= 0).sum())})
    return {"path_lookup": lookup, "prefix_search": prefix}


# ---------------------------------------------------------------------------
# phase 3 / 5: the query operators at deployment size
# ---------------------------------------------------------------------------
def synthetic_store(scale_log2: int):
    """/dimDD/topic_DDTTT/entity_TTTKK: 16 dimensions x 256 topics x
    2^scale_log2 / 4096 entities — a depth-3 tree, every path <= 40
    bytes, built through PathStore.put_record into one MemKV whose
    memtable is compacted into a single sorted run at the end."""
    from repro_torch.core import records as R
    from repro_torch.core.store import MemKV, PathStore
    n_files = (1 << scale_log2) // (N_DIMS * N_TOPICS)
    store = PathStore(MemKV(memtable_limit=1 << 62))
    dims = [f"dim{d:02d}" for d in range(N_DIMS)]
    store.put_record("/", R.DirRecord(name="", sub_dirs=dims))
    for d, dim in enumerate(dims):
        topics = [f"topic_{d:02d}{t:03d}" for t in range(N_TOPICS)]
        store.put_record(f"/{dim}", R.DirRecord(name=dim, sub_dirs=topics,
                                                summary=f"dimension {d}"))
        for t, topic in enumerate(topics):
            files = [f"entity_{t:03d}{k:03d}" for k in range(n_files)]
            store.put_record(f"/{dim}/{topic}", R.DirRecord(name=topic, files=files))
            base = f"/{dim}/{topic}/"
            for f in files:
                store.put_record(base + f, R.FileRecord(name=f, text=f"{topic} {f} note"))
    store.engine.compact()
    return store, dims, n_files


def canon(x):
    if x is None or isinstance(x, (str, int, float)):
        return x
    if hasattr(x, "to_bytes"):
        return x.to_bytes()
    return [canon(v) for v in x]


def run_wave(engine, method: str, args, limit=None):
    """One BatchPlanner wave of one operator; (answers, host ms)."""
    import torch
    from repro_torch.core.engine import BatchPlanner
    planner = BatchPlanner(engine)
    fn = getattr(planner, method)
    futs = [fn(a) if limit is None else fn(a, limit) for a in args]
    t0 = time.perf_counter()
    planner.flush()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return [f.result() for f in futs], ms


def wave_batches(rng, dims, n_files, extra=()):
    def file_path():
        d, t, k = rng.randrange(N_DIMS), rng.randrange(N_TOPICS), rng.randrange(n_files)
        return f"/{dims[d]}/topic_{d:02d}{t:03d}/entity_{t:03d}{k:03d}"

    def topic_path():
        d, t = rng.randrange(N_DIMS), rng.randrange(N_TOPICS)
        return f"/{dims[d]}/topic_{d:02d}{t:03d}"
    q1 = [file_path() for _ in range(4096 - 96 - len(extra))] + list(extra)
    q1 += [topic_path() for _ in range(64)] + ["/"] + [f"/{d}" for d in dims]
    q1 += [f"/dim99/none_{i}" for i in range(15)]
    q2 = [topic_path() for _ in range(1000)] + ["/"] + [f"/{d}" for d in dims] + \
        [file_path() for _ in range(7)]
    q3 = [file_path() for _ in range(1016)] + [f"/{dims[0]}/missing/x{i}" for i in range(8)]
    q4 = [topic_path() for _ in range(60)] + [f"/{dims[1]}", "/dim0", "/nope",
                                               f"/{dims[2]}/topic_02007/"]
    q4c = [f"{rng.randrange(N_DIMS):02d}{rng.randrange(N_TOPICS):03d}" for _ in range(248)]
    q4c += [f"{rng.randrange(N_TOPICS):03d}{rng.randrange(n_files):03d}" for _ in range(4)]
    q4c += ["nothere", "zzz", "dim03", "summary"]
    return {"q1": ("get", q1), "q2": ("ls", q2), "q3": ("navigate", q3),
            "q4": ("search", q4), "q4c": ("contains", q4c)}


def query_phase(dev, scale_log2: int):
    """Build the synthetic wiki and both engines; returns them with the
    first wave's batches (for the storage-kernel checks)."""
    from repro_torch.core.engine import DeviceEngine, HostEngine
    t0 = time.perf_counter()
    store, dims, n_files = synthetic_store(scale_log2)
    t_store = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_eng = DeviceEngine.from_store(store, device=dev)
    t_dev = time.perf_counter() - t0
    host = HostEngine(store)
    st = dev_eng.epoch_view()
    emit({"phase": "synthetic_wiki", "paths": dev_eng.wiki.n, "files": N_DIMS * N_TOPICS * n_files,
          "token_matrix_bytes": st.ptoks.numel(), "digest_keys": st.keys.numel(),
          "build_store_s": t_store, "device_engine_s": t_dev})
    return store, dims, n_files, dev_eng, host


def drive_waves(tag, dev_eng, host, batches) -> dict:
    out = {}
    for op, (method, args) in batches.items():
        got, ms = run_wave(dev_eng, method, args)
        want, host_ms = run_wave(host, method, args)
        check(canon(got) == canon(want), f"{tag} {op}: device answers differ from the HostEngine")
        if op == "q4":
            check(sum(len(x) for x in got) > 0, f"{tag} q4: no prefix matched")
        out[op] = {"n": len(args), "device_ms": ms, "host_ms": host_ms}
    emit({"phase": "query_waves", "tag": tag, "waves": out})
    return out


def write_wave(dev_eng, dims, rng):
    from repro_torch.core import records as R
    from repro_torch.core.engine import BatchPlanner
    planner = BatchPlanner(dev_eng)
    new = []
    for i in range(64):
        d, t = rng.randrange(N_DIMS), rng.randrange(4)
        path = f"/{dims[d]}/topic_{d:02d}{t:03d}/online_{i:03d}"
        planner.admit(path, R.FileRecord(name=f"online_{i:03d}", text=f"admitted {i}"))
        new.append(path)
    futs_done = planner.flush()
    t0 = time.perf_counter()
    epoch = dev_eng.refresh()
    ms = (time.perf_counter() - t0) * 1e3
    check(dev_eng.last_refresh_kind == "patch",
          f"write wave refresh took the {dev_eng.last_refresh_kind} path, not patch")
    emit({"phase": "write_wave", "admits": len(new), "flushed": futs_done,
          "epoch": epoch, "refresh_kind": dev_eng.last_refresh_kind, "refresh_ms": ms})
    return new


# ---------------------------------------------------------------------------
# phase 6: serving at full width
# ---------------------------------------------------------------------------
def serve_once(device, n_docs=160, seed=0, n_requests=8):
    """Serve AuthTrace questions with wikikv-router over a DeviceEngine on
    ``device``; returns (requests, per-decode-step log, serve calls)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import records as R
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.oracle import HeuristicOracle
    from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig
    from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import Request, ServingEngine

    docs, questions = generate_authtrace(
        AuthTraceConfig(n_docs=n_docs, n_questions=100, seed=seed))
    pipe = ConstructionPipeline(PipelineConfig(), HeuristicOracle())
    pipe.writer.clock = lambda: 0.0          # the two runs build the same bytes
    pipe.bootstrap(docs)
    for i in range(0, len(docs), 16):
        pipe.ingest(docs[i:i + 16])
    cfg = get_config("wikikv-router")
    tok = HashTokenizer(vocab_size=cfg.vocab).fit([d["text"] for d in docs])
    params = M.init_params(cfg, seed=seed, device=device)
    oracle = HeuristicOracle()
    eng = ServingEngine(cfg, params, tok, DeviceEngine.from_store(pipe.store, device=device),
                        oracle, batch_size=4, max_len=512, device=device)
    for i in range(4):
        eng.submit_admit(f"/entities/online_{i}",
                         R.FileRecord(name=f"online_{i}", text=f"online admit {i}"))
    log, calls = [], {"n": 0, "prefill": False}
    serve, prefill = eng._serve, eng._prefill

    def logged_serve(params_, state, batch):
        nxt, logits, state = serve(params_, state, batch)
        calls["n"] += 1
        if not calls["prefill"]:
            top2 = torch.topk(logits[:, :cfg.vocab].float(), 2, dim=-1).values
            log.append((nxt.cpu().tolist(), (top2[:, 0] - top2[:, 1]).cpu().tolist(),
                        top2[:, 0].abs().cpu().tolist(), list(eng._decoding)))
        return nxt, logits, state

    def flagged_prefill(slot, req):
        calls["prefill"] = True
        try:
            prefill(slot, req)
        finally:
            calls["prefill"] = False

    eng._serve, eng._prefill = logged_serve, flagged_prefill
    reqs = [Request(rid=q.qid, query=q.text, max_new_tokens=16) for q in questions[:n_requests]]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == n_requests, f"served {len(done)} of {n_requests} requests")
    evidence = {r.rid: oracle.answer(r.query, [x.text for x in r.nav_results if x.text])
                for r in done}
    admitted = eng.engine.q1_get([f"/entities/online_{i}" for i in range(4)])
    check(all(a is not None for a in admitted), "an online admit is not readable")
    return done, evidence, log, calls["n"], wall


def serving_phase(dev) -> dict:
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    gpu_done, gpu_ev, gpu_log, gpu_calls, gpu_wall = serve_once(dev)
    counts = dict(ops.LAUNCHES)
    emit({"phase": "serving", "device": "cuda", "requests": len(gpu_done),
          "serve_steps": gpu_calls, "wall_s": gpu_wall, "launches": counts})
    check(counts["path_lookup"] > 0, "serving ran no path_lookup")
    check(counts["rmsnorm"] == 17 * gpu_calls,
          f"rmsnorm launches {counts['rmsnorm']} != 17 x {gpu_calls} decode steps")
    check(counts["decode_attention"] == 4 * gpu_calls,
          f"decode_attention launches {counts['decode_attention']} != 4 x {gpu_calls}")
    cpu_done, cpu_ev, cpu_log, cpu_calls, cpu_wall = serve_once(torch.device("cpu"))
    emit({"phase": "serving", "device": "cpu", "requests": len(cpu_done),
          "serve_steps": cpu_calls, "wall_s": cpu_wall})

    def nav(r):
        return (r.rid, r.trace.tool_calls, r.trace.pages_read, [x.path for x in r.nav_results])
    check([nav(r) for r in gpu_done] == [nav(r) for r in cpu_done],
          "navigation traces differ between the card and the CPU")
    check(gpu_ev == cpu_ev, "evidence answers differ between the card and the CPU")
    # greedy tokens: equal at every decode step, unless the CPU run's top-2
    # logit gap at the first differing step is below the f32 tolerance
    near_tie = None
    compared = 0
    for step, (g, c) in enumerate(zip(gpu_log, cpu_log)):
        lanes = [i for i, on in enumerate(c[3]) if on]
        diff = [i for i in lanes if g[0][i] != c[0][i]]
        if diff:
            i = diff[0]
            gap, tol = c[1][i], F32_TOL["atol"] + F32_TOL["rtol"] * c[2][i]
            check(gap < tol, f"decode step {step} lane {i}: tokens differ "
                  f"(card {g[0][i]}, cpu {c[0][i]}) with a top-2 gap {gap} >= {tol}")
            near_tie = {"step": step, "lane": i, "gap": gap, "tol": tol}
            break
        compared += 1
    if near_tie is None:
        check(len(gpu_log) == len(cpu_log) and gpu_calls == cpu_calls,
              "the two runs took different numbers of steps")
        check([r.answer for r in gpu_done] == [r.answer for r in cpu_done],
              "answers differ between the card and the CPU")
    min_gap = min((min(c[1][i] for i, on in enumerate(c[3]) if on)
                   for c in cpu_log if any(c[3])), default=None)
    emit({"phase": "serving_parity", "decode_steps_compared": compared,
          "tokens_equal": near_tie is None, "near_tie": near_tie,
          "min_top2_gap_cpu": min_gap})
    return counts


# ---------------------------------------------------------------------------
def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke needs the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    from repro_torch.kernels import build, ops
    from repro_torch.models.layers import set_fp32_matmul
    set_fp32_matmul()
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    t0 = time.perf_counter()
    nvcc_s = build.build_all()
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 256):
            x = torch.ones((2, D), dtype=dtype, device=dev)
            ops.rmsnorm(x, torch.ones((D,), dtype=dtype, device=dev))
            ops.rmsnorm(x, None)
    torch.cuda.synchronize()
    emit({"phase": "build", "nvcc_s": nvcc_s, "cuda_build_s": t_cuda,
          "triton_first_launch_s": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in (build.BUILD_DIR / f"{n}.log").read_text()
                        .splitlines() if "registers" in ln][:2]
                    for n in build.SOURCES if (build.BUILD_DIR / f"{n}.log").exists()}})

    entries = model_kernels(dev)

    rng = random.Random(0)
    store, dims, n_files, dev_eng, host = query_phase(dev, SCALE_LOG2)
    batches = wave_batches(rng, dims, n_files)
    entries.update(storage_kernels(dev, dev_eng, batches["q1"][1], batches["q4"][1]))

    # the query path: counts from zero, read just after
    ops.reset_launches()
    drive_waves("before_write", dev_eng, host, batches)
    new = write_wave(dev_eng, dims, rng)
    batches2 = wave_batches(rng, dims, n_files, extra=new)
    batches2["q4"] = ("search", batches2["q4"][1][:-8] + sorted(
        {p.rsplit("/", 1)[0] for p in new})[:8])
    drive_waves("after_write", dev_eng, host, batches2)
    query_counts = dict(ops.LAUNCHES)
    emit({"phase": "query_path_launches", "launches": query_counts})
    check(query_counts["path_lookup"] > 0, "the query waves ran no path_lookup")
    check(query_counts["prefix_search"] > 0, "the Q4 waves ran no prefix_search")
    del store, dev_eng, host
    torch.cuda.empty_cache()

    serve_counts = serving_phase(dev)

    kernels = []
    for name in ("path_lookup", "prefix_search", "rmsnorm", "decode_attention"):
        e = entries[name]
        e["launches"] = query_counts[name] + serve_counts[name]
        check(e["launches"] > 0, f"{name} was never launched on the main path")
        kernels.append({k: e[k] for k in ("name", "route", "source", "replaces", "launches",
                                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "shape")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

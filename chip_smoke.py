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
     versions on that engine's own tensors, timed (the card's own time,
     the host's, one kernel node a call); prefix_search also at every row
     length, Q = 1, 5, 64 and 300, on the table's rows in their own order
     and shuffled;
  5. BatchPlanner waves of 4096 Q1, 1024 Q2, 1024 Q3, 64 Q4 and 256 Q4C
     ops, equal to the HostEngine's answers, then a write wave of 64
     admits whose refresh must patch, then the waves again;
  6. the wikikv-router serving loop at full width over the AuthTrace wiki
     on the card, against the same run on the CPU (plain versions);
  7. flash_attention against its plain version at the oracle's, qwen3
     prefill, chunked-prefill, non-causal ragged and group-6 shapes, timed
     beside the plain version and SDPA;
  8. LM-routed navigation: the same serving run with a wikikv-router
     ModelOracle (two loss evaluations per decision, flash_attention in
     every layer) on the card and on the CPU, decisions and traces equal;
  9. qwen3-1.7B at full width (28 layers, random weights from the seed):
     make_prefill_step and make_eval_step at B=1, S=4096 on the card,
     launches per forward, a finite loss, and logit parity with the CPU
     at 2 layers and S=256;
 10. moe_router against its plain version at the dbrx prefill and decode,
     jamba, kimi-k2 and ragged shapes (tie-laden logits too), timed beside
     the plain version and the softmax -> topk -> renorm composite (the
     card's own time, the host's, one kernel node a call); then
     dbrx-132b at full width (8 of its 40 layers, weights drawn on the
     card from the seed): make_prefill_step and make_eval_step at B=1,
     S=4096 and 16 make_serve_step decode steps at B=4, launches per
     forward and per step, times beside their bounds; f32 parity of its
     first 2 layers with the CPU (router indices, logits), the bf16 run's
     share of changed expert assignments, and teacher-forced decode
     against the prefill;
 11. one JSON line of every kernel with its launches, error, times and
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
BF16_FLOPS = 989e12        # bfloat16 on the tensor cores
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


def host_ms(fn, calls: int = 500, warmup: int = 50) -> float:
    """The caller's host time for one call of ``fn`` in ms: ``calls`` calls
    in a row on the host's clock, synchronised only after (few enough that
    the launch queue never fills).  For a launch-bound kernel, ``ms`` is
    about this plus the event floor."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def profiled_ms(fn, inputs, calls: int) -> float | None:
    """Device time of one call ``fn(*inputs)`` in ms from ``torch.profiler``'s
    ``key_averages()`` over ``calls`` eager calls; None where the profiler
    shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*inputs)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    return us / 1e3 / calls if us > 0 else None


def graph_ms(fn, inputs, calls: int = 32, replays: int = 5, warmup: int = 3) -> dict:
    """The card's own time for one call ``fn(*inputs)``, the wrapper's host
    work left out: ``calls`` calls captured in a CUDA graph (after
    ``warmup`` eager calls, so that any cached workspace exists first),
    the graph replayed ``replays`` times between two CUDA events, per
    call; with the graph's kernel and total node counts.

    A cold-L2 time, comparable with a bytes bound: the tensors of
    ``inputs`` are cloned into as many copies as fill twice the card's L2
    (at most ``calls``), call i reads copy i mod copies, and every call's
    output stays alive until the graph is freed, so no call finds its
    inputs or its output where an earlier call left them in L2.  Where
    ``fn`` cannot be captured, the profiler's device time of eager calls
    (or None) and the reason, which is also printed."""
    import torch
    from repro_torch.kernels import build
    nbytes = sum(t.numel() * t.element_size() for t in inputs if isinstance(t, torch.Tensor))
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    n_copies = max(1, min(calls, -(-2 * l2 // max(nbytes, 1))))
    copies = [inputs] + [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in inputs)
                         for _ in range(n_copies - 1)]
    for _ in range(warmup):
        fn(*inputs)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(g):
            outs = [fn(*copies[i % n_copies]) for i in range(calls)]
        kernels, nodes = build.graph_nodes(g)
    except Exception as exc:        # reported, then measured another way
        del g
        torch.cuda.synchronize()
        reason = f"not captured: {type(exc).__name__}: {exc}"
        emit({"phase": "device_ms_unavailable", "reason": reason})
        return {"device_ms": profiled_ms(fn, inputs, calls), "by": "torch.profiler",
                "reason": reason}
    g.instantiate()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del g, outs, copies
    return {"device_ms": ms, "by": "cuda graph", "kernel_nodes": kernels, "nodes": nodes,
            "calls": calls, "input_copies": n_copies}


def one_kernel_a_call(name: str, gm: dict) -> None:
    """Fail unless ``gm`` (from ``graph_ms``) captured its calls and each
    made exactly one kernel node and no other node."""
    check(gm["by"] == "cuda graph" and gm["kernel_nodes"] == gm["nodes"] == gm["calls"],
          f"{name}: {gm}; not one kernel node a call")


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


def norm_row(x, s, err) -> dict:
    """rmsnorm timed at x's shape with scale s, beside its plain version,
    ``F.rms_norm`` and its bytes bound; the achieved GB/s and the ratio to
    the library call of the same run."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    rows, D = x.shape
    elt = x.element_size()
    nbytes = 2 * rows * D * elt + D * s.element_size()
    b, by = bound(nbytes, 4 * rows * D, F32_FLOPS)
    ms = cuda_ms(lambda: rn.rmsnorm(x, s))
    dev = graph_ms(rn.rmsnorm, (x, s))["device_ms"]
    lib_fn = ((lambda x, s: F.rms_norm(x, (D,), s, eps=1e-6)) if hasattr(F, "rms_norm")
              else None)
    lib = cuda_ms(lambda: lib_fn(x, s)) if lib_fn else None
    return {"shape": f"x ({rows}, {D}) {str(x.dtype).split('.')[1]} with scale",
            "max_abs_err": err, "ms": ms, "device_ms": dev,
            "plain_ms": cuda_ms(lambda: ref.rmsnorm_ref(x, s)), "library_ms": lib,
            "library_device_ms": graph_ms(lib_fn, (x, s))["device_ms"] if lib_fn else None,
            "bound_ms": b, "bound_by": by, "gb_per_s": nbytes / ms / 1e6,
            "share_of_bound": b / ms, "vs_library": ms / lib if lib else None,
            "device_share_of_bound": b / dev if dev else None}


def model_kernels(dev) -> dict:
    """rmsnorm and decode_attention at the serving shapes (batch 4 lanes,
    wikikv-router: 4 query heads, 2 KV heads, head_dim 64, d_model 256,
    max_len 512), the longer-cache shapes, qwen3-1.7B's prefill norms and
    dbrx-132b's (d_model 6144; decode at group 6: 48 query heads, 8 KV
    heads, head_dim 128, B=4, max_len 512); returns the JSON entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention as da
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
                entries["rmsnorm"] = {
                    "name": "rmsnorm", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "replaces": "src/repro/kernels/rmsnorm.py:37",
                    **norm_row(x, s, err)}
    # the prefill shapes of qwen3-1.7B at S=4096: a block norm over 4096
    # rows of d_model 2048, the qk-norm over 4096 x 16 rows of head_dim 128;
    # dbrx-132b's block norm at S=4096 and at a decode step of B=4
    shapes = []
    for rows, D in ((4096, 2048), (4096 * 16, 128), (4096, 6144), (4, 6144)):
        x = torch.randn((rows, D), generator=g).to(dev, torch.bfloat16)
        s = torch.randn((D,), generator=g).to(dev, torch.bfloat16)
        err = check_float(f"rmsnorm {rows}x{D}", ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s),
                          torch.bfloat16)
        shapes.append(norm_row(x, s, err))
    entries["rmsnorm"]["shapes"] = shapes
    emit({"phase": "model_kernels", "rmsnorm": "ok",
          "rmsnorm_ms": entries["rmsnorm"]["ms"],
          "shapes": [{k: v for k, v in entries["rmsnorm"].items()
                      if k not in ("name", "route", "source", "replaces", "shapes")}] + shapes})

    timings, group6 = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, lens, Hq, Hkv, D in (
                (4, 512, [1, 97, 311, 512], 4, 2, 64),
                (8, 512, [1, 7, 64, 129, 256, 300, 511, 512], 4, 2, 64),
                (8, 4096, [1, 100, 1000, 2049, 3000, 4000, 4095, 4096], 4, 2, 64),
                # dbrx's decode: the smoke's lanes at 0, 1/5, 1/2 and the
                # end of a 512 cache, one token in
                (4, 512, [1, 103, 257, 497], 48, 8, 128)):
            q = torch.randn((B, Hq, D), generator=g).to(dev, dtype)
            k = torch.randn((B, Hkv, S, D), generator=g).to(dev, dtype)
            v = torch.randn((B, Hkv, S, D), generator=g).to(dev, dtype)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = ops.decode_attention(q, k, v, ln)
            want = ref.decode_attention_ref(q, k, v, ln)
            err = check_float(f"decode_attention B={B} Hq={Hq} Hkv={Hkv} S={S}", got, want, dtype)
            ms = cuda_ms(lambda: da.decode_attention(q, k, v, ln))
            gm = graph_ms(da.decode_attention, (q, k, v, ln))
            one_kernel_a_call(f"decode_attention B={B} Hq={Hq} S={S} {dtype}", gm)
            warps, blocks, split = da.decode_plan(B, Hkv, Hq // Hkv, S, D, q.element_size(),
                                                  build.sm_count(q.get_device()))
            live = sum(lens)
            elt = q.element_size()
            b, by = bound(2 * Hkv * D * elt * live + 2 * B * Hq * D * elt + 4 * B,
                          4.0 * Hq * D * live, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
            timings.append({"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "dtype": str(dtype),
                            "plan": {"warps": warps, "blocks": blocks, "split": split},
                            "ms": ms, "device_ms": gm["device_ms"], "bound_ms": b, "err": err})
            if S != 512 or B != 4 or (Hq == 4 and dtype != torch.float32):
                continue
            # the yardstick: one SDPA call over the group-expanded cache with
            # the length mask (expanded outside the timing)
            mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[:, None, None, :]
            kx, vx = k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1)

            def sdpa(q, kx, vx):
                return F.scaled_dot_product_attention(q[:, :, None, :], kx, vx, attn_mask=mask)
            row = {"shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} lengths={lens} "
                            f"{str(dtype).split('.')[1]}",
                   "max_abs_err": err, "ms": ms, "device_ms": gm["device_ms"],
                   "plain_ms": cuda_ms(lambda: ref.decode_attention_ref(q, k, v, ln)),
                   "library_ms": cuda_ms(lambda: sdpa(q, kx, vx)),
                   "library_device_ms": graph_ms(sdpa, (q, kx, vx))["device_ms"],
                   "host_ms": host_ms(lambda: da.decode_attention(q, k, v, ln)),
                   "library_host_ms": host_ms(lambda: sdpa(q, kx, vx)),
                   "bound_ms": b, "bound_by": by}
            if Hq == 4:
                entries["decode_attention"] = {
                    "name": "decode_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "replaces": "src/repro/kernels/decode_attention.py:74", **row}
            else:
                group6.append(row)
    entries["decode_attention"]["shapes"] = group6
    emit({"phase": "model_kernels", "decode_attention": "ok", "times": timings,
          "group6": group6})
    return entries


# (tag, B, Hq, Hkv, Sq, Skv, D, dtype, causal): (a) the ModelOracle's
# wikikv-router NLLs, (b) qwen3-1.7B prefill, (c) its chunked prefill,
# (d) whisper-medium's cross-attention shape (448 decoder x 1500 encoder
# positions, non-causal), (e) dbrx's group of 6 (48 / 8 heads)
FLASH_SHAPES = [
    ("a S=7", 1, 4, 2, 7, 7, 64, "float32", True),
    ("a S=37", 1, 4, 2, 37, 37, 64, "float32", True),
    ("a S=113", 1, 4, 2, 113, 113, 64, "float32", True),
    ("b", 1, 16, 8, 4096, 4096, 128, "bfloat16", True),
    ("c", 1, 16, 8, 128, 4096, 128, "bfloat16", True),
    ("d", 1, 16, 16, 448, 1500, 64, "bfloat16", False),
    ("e", 1, 48, 8, 1024, 1024, 128, "bfloat16", True),
]


def attn_work(B, Hq, Hkv, Sq, Skv, D, causal, elt) -> tuple[float, float]:
    """(bytes, flops) of attention at these shapes: q, k and v read once,
    the output written once; 4·D flops per visible (query, key) pair."""
    off = Skv - Sq
    pairs = sum(min(i + off + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    return elt * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D), 4.0 * D * pairs * B * Hq


def sdpa_mask(q, k, causal):
    """The mask that lets one SDPA call compute the same function (the
    yardstick only): the causal mask of a chunked prefill (Sq < Skv) is
    lower-right aligned, which ``is_causal`` is not, so it goes in as a
    boolean mask; None where ``is_causal`` says it."""
    import torch
    Sq, Skv = q.shape[2], k.shape[2]
    if not causal or Sq == Skv:
        return None
    return (torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
            >= torch.arange(Skv, device=q.device)[None, :])


def sdpa(q, k, v, causal, mask):
    """One SDPA call with ``sdpa_mask``'s mask."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=causal and mask is None, enable_gqa=True)


def attention_kernels(dev) -> dict:
    """flash_attention against its plain version (``ref.attention_ref``) at
    FLASH_SHAPES, timed beside it and beside SDPA; the kernels-line entry
    is shape (b)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cpu").manual_seed(1)
    rows, entry = [], None
    for tag, B, Hq, Hkv, Sq, Skv, D, dt, causal in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, Hq, Sq, D), generator=g).to(dev, dtype)
        k = torch.randn((B, Hkv, Skv, D), generator=g).to(dev, dtype)
        v = torch.randn((B, Hkv, Skv, D), generator=g).to(dev, dtype)
        got = ops.attention(q, k, v, causal=causal)
        err = check_float(f"flash_attention ({tag})", got, ref.attention_ref(q, k, v, causal=causal),
                          dtype)
        nbytes, flops = attn_work(B, Hq, Hkv, Sq, Skv, D, causal, q.element_size())
        b, by = bound(nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
        n = 10 if Sq * Skv * Hq > (1 << 24) else 25
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal), iters=n)
        mask = sdpa_mask(q, k, causal)
        lib = cuda_ms(lambda: sdpa(q, k, v, causal, mask), iters=n)
        dev_ms = graph_ms(lambda q, k, v: fa.flash_attention(q, k, v, causal=causal),
                          (q, k, v), calls=20)["device_ms"]
        row = {"shape": f"({tag}) B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} {dt} "
                        f"{'causal' if causal else 'non-causal'}",
               "block_q": fa.query_tile(B, Hq, Sq) if dt == "bfloat16" else fa.BLOCK_Q,
               "max_abs_err": err, "gflop": flops / 1e9, "ms": ms, "device_ms": dev_ms,
               "plain_ms": cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal), iters=n),
               "library_ms": lib,
               "library_device_ms": graph_ms(lambda q, k, v: sdpa(q, k, v, causal, mask),
                                             (q, k, v), calls=20)["device_ms"],
               "bound_ms": b, "bound_by": by,
               "tflop_per_s": flops / ms / 1e9, "library_tflop_per_s": flops / lib / 1e9,
               "share_of_bound": b / ms, "vs_library": ms / lib}
        rows.append(row)
        if tag == "b":
            entry = {"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:94", **row}
        del q, k, v, got
    torch.cuda.empty_cache()
    emit({"phase": "flash_attention", "shapes": rows})
    return {"flash_attention": entry}


# lengths the extra prefix_search cases cycle through on the synthetic
# wiki's rows (/dimDD/topic_DDTTT/entity_TTTKK: '/' at bytes 0, 6 and 18,
# 32 bytes in all): empty, one byte, a dimension, a dimension and its '/',
# a cut topic (the next byte a digit), a topic, a topic and its '/', a
# whole path; L itself is added at each row length
PREFIX_LENS = (0, 1, 6, 7, 17, 18, 19, 32)


def prefix_search_cases(toks96) -> list:
    """prefix_search against its plain version beyond the engine's own
    call: at every L in ROW_LENGTHS (the engine's rows cut or padded to
    L, every 5th row of the table, free and tombstone rows added), Q = 1,
    5, 64 and 300 (two launches, output rows 300 bytes apart), lengths 0
    and L and prefixes ending in '/' among them, rows in the table's own
    order (the digest order, which clusters rows loosely by prefix) and
    shuffled.  Returns one entry a case; fails on the first bitmap that
    differs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.prefix_search import ROW_LENGTHS
    g = torch.Generator(device="cpu").manual_seed(3)
    dev = toks96.device
    base = toks96[::5]
    cases = []
    for L in ROW_LENGTHS:
        t = torch.zeros((base.shape[0] + 64, L), dtype=torch.uint8, device=dev)
        t[:base.shape[0], :min(L, 96)] = base[:, :min(L, 96)]
        t[-32:] = 255                                    # tombstones; the 32 before are free
        for order in ("table", "shuffled"):
            rows = t if order == "table" else t[torch.randperm(t.shape[0], generator=g)
                                                 .to(dev)]
            for Q in (1, 5, 64, 300):
                pick = torch.randint(0, base.shape[0], (Q,), generator=g).to(dev)
                lens = torch.tensor([(PREFIX_LENS + (L,))[i % (len(PREFIX_LENS) + 1)]
                                     for i in range(Q)], dtype=torch.int32)
                lens = lens.clamp(max=L).to(dev)
                prefs = t[pick].clone()
                if Q > 1:
                    prefs[-1], lens[-1] = 255, 1                 # the engine's padding prefix
                got = ops.prefix_search(rows, prefs, lens)
                check(torch.equal(got, ref.prefix_search_ref(rows, prefs, lens)),
                      f"prefix_search disagrees with its plain version at L={L}, Q={Q}, "
                      f"{order} rows")
                cases.append({"L": L, "Q": Q, "order": order, "rows": rows.shape[0],
                              "matches": int(got.sum())})
    check(all(c["matches"] > 0 for c in cases), "an extra prefix_search case matched nothing")
    return cases


def storage_kernels(dev, eng, q1_paths, q4_prefixes) -> dict:
    """path_lookup and prefix_search on the DeviceEngine's own tensors
    (the sorted digest view with its pinned staging, the token matrix)
    with the query batches of the waves."""
    import numpy as np
    import torch
    from repro_torch.core import tensorstore as TS
    from repro_torch.kernels import build, ops, ref
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
        "geometry": dict(zip(("blocks", "top_stride", "n_top", "n_pin_staged", "smem_bytes"),
                             pl.lookup_geometry(Q, N, P))),
        "max_abs_err": max_err(got, want),
        "ms": cuda_ms(lambda: pl.path_lookup(keys, queries, pinned=pinned)),
        "device_ms": graph_ms(lambda k, q, pk, pp: pl.path_lookup(k, q, pinned=(pk, pp)),
                              (keys, queries, *pinned))["device_ms"],
        "plain_ms": cuda_ms(lambda: ref.path_lookup_pinned_ref(keys, queries, *pinned)),
        "library_ms": cuda_ms(lambda: torch.searchsorted(keys, queries)),
        "library_device_ms": graph_ms(torch.searchsorted, (keys, queries))["device_ms"],
        "host_ms": host_ms(lambda: pl.path_lookup(keys, queries, pinned=pinned)),
        "library_host_ms": host_ms(lambda: torch.searchsorted(keys, queries)),
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
    extra = prefix_search_cases(toks)
    Nr, Qp = toks.shape[0], pt.shape[0]
    b, by = bound(Nr * L + Qp * L + Qp * 4 + Nr * Qp, Nr * Qp * L, INT8_OPS)
    gm = graph_ms(ps.prefix_search, (toks, pt, lt), calls=20)
    one_kernel_a_call("prefix_search", gm)
    prefix = {
        "name": "prefix_search", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefix_search.cu",
        "replaces": "src/repro/kernels/prefix_search.py:52",
        "shape": f"tokens ({Nr}, {L}) uint8, Q={Qp} prefixes",
        "geometry": dict(zip(("blocks", "rows_per_tile", "smem_bytes"),
                             ps.search_geometry(Nr, L, Qp, build.sm_count(toks.get_device())))),
        "max_abs_err": max_err(got, want),
        "ms": cuda_ms(lambda: ps.prefix_search(toks, pt, lt)),
        "device_ms": gm["device_ms"],
        "host_ms": host_ms(lambda: ps.prefix_search(toks, pt, lt), calls=200, warmup=20),
        "plain_ms": cuda_ms(lambda: ref.prefix_search_ref(toks, pt, lt), iters=5),
        "library_ms": None, "library_device_ms": None,
        "bound_ms": b, "bound_by": by, "extra_shapes_equal": extra}
    torch.cuda.empty_cache()
    emit({"phase": "storage_kernels",
          "path_lookup": {k: v for k, v in lookup.items()
                          if k not in ("name", "route", "source", "replaces")},
          "prefix_search": {k: v for k, v in prefix.items()
                            if k not in ("name", "route", "source", "replaces")},
          "path_lookup_hits": int((got_np >= 0).sum())})
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
# phases 6 and 8: serving at full width, with the heuristic or the LM oracle
# ---------------------------------------------------------------------------
NEAR_TIE = 1e-4   # a decision margin below this may flip on float rounding


def instrument_oracle(oracle) -> dict:
    """Record every NLL of a ModelOracle (value, host ms) and every LM
    decision with its margin: the NLL gap of classify_query's two routes,
    |coverage - theta| of needs_deeper."""
    log = {"nll": [], "ms": [], "decisions": []}
    nll, classify, deeper = oracle._nll, oracle.classify_query, oracle.needs_deeper

    def logged_nll(prefix, target):
        t0 = time.perf_counter()
        value = nll(prefix, target)
        log["ms"].append((time.perf_counter() - t0) * 1e3)
        log["nll"].append(value)
        return value

    def logged_classify(q):
        n0 = len(log["nll"])
        route = classify(q)
        vals = log["nll"][n0:]
        log["decisions"].append(("classify_query", route,
                                 abs(vals[0] - vals[1]) if vals else None))
        return route

    def logged_deeper(q, content, theta=0.34):
        n0 = len(log["nll"])
        answer = deeper(q, content, theta)
        margin = None
        if len(log["nll"]) > n0:
            cond, uncond = log["nll"][n0:]
            cov = max(0.0, min(1.0, (uncond - cond) / max(uncond, 1e-6) + 0.5))
            margin = abs(cov - theta)
        log["decisions"].append(("needs_deeper", answer, margin))
        return answer

    oracle._nll, oracle.classify_query, oracle.needs_deeper = (
        logged_nll, logged_classify, logged_deeper)
    return log


def serve_once(device, model_oracle=False, n_docs=160, seed=0, n_requests=8) -> dict:
    """Serve AuthTrace questions with wikikv-router over a DeviceEngine on
    ``device``; the navigation oracle is the heuristic one, or with
    ``model_oracle`` a ModelOracle over the same LM.  Returns the requests,
    their evidence answers, the per-decode-step log, the serve calls, the
    wall time and the oracle's log."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import records as R
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.oracle import HeuristicOracle
    from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig
    from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import model as M
    from repro_torch.runtime.model_oracle import ModelOracle
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
    olog = None
    if model_oracle:
        oracle = ModelOracle(cfg, params, tok, device=device)
        olog = instrument_oracle(oracle)
    else:
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
    return {"done": done, "evidence": evidence, "log": log, "calls": calls["n"],
            "wall": wall, "oracle": olog}


def decision_parity(gpu_log, cpu_log) -> tuple[dict | None, float]:
    """The LM decisions of the two runs, in order: equal, unless the first
    one that differs has a CPU-side margin below NEAR_TIE (then it is
    reported and the runs are compared no further).  Returns (near tie or
    None, max |NLL card - NLL cpu| over the calls both runs made alike)."""
    max_dnll = max((abs(a - b) for a, b in zip(gpu_log["nll"], cpu_log["nll"])), default=0.0)
    for i, (g, c) in enumerate(zip(gpu_log["decisions"], cpu_log["decisions"])):
        if g[:2] != c[:2]:
            check(g[0] == c[0] and c[2] is not None and c[2] < NEAR_TIE,
                  f"oracle decision {i} differs (card {g}, cpu {c}) beyond a near tie")
            return {"decision": i, "kind": c[0], "card": g[1], "cpu": c[1],
                    "margin_cpu": c[2], "margin_card": g[2]}, max_dnll
    check(len(gpu_log["decisions"]) == len(cpu_log["decisions"]),
          "the two runs made different numbers of oracle decisions")
    return None, max_dnll


def serving_phase(dev, model_oracle=False) -> dict:
    """One serving run on the card, the same on the CPU, and the two held
    equal: navigation traces and results, evidence answers, greedy tokens
    (and with ``model_oracle`` every LM decision)."""
    import torch
    from repro_torch.kernels import ops
    phase = "oracle_navigation" if model_oracle else "serving"
    ops.reset_launches()
    gpu = serve_once(dev, model_oracle)
    counts = dict(ops.LAUNCHES)
    n_nll = len(gpu["oracle"]["nll"]) if model_oracle else 0
    calls = gpu["calls"]

    def summary(run, device):
        out = {"phase": phase, "device": device, "requests": len(run["done"]),
               "serve_steps": run["calls"], "wall_s": run["wall"]}
        if model_oracle:
            o = run["oracle"]
            out.update(nll_calls=len(o["nll"]), decisions=len(o["decisions"]),
                       oracle_ms_per_nll=statistics.mean(o["ms"]),
                       oracle_ms_per_nll_median=statistics.median(o["ms"]),
                       oracle_s=sum(o["ms"]) / 1e3)
        return out
    emit({**summary(gpu, "cuda"), "launches": counts})
    check(counts["path_lookup"] > 0, f"{phase} ran no path_lookup")
    check(counts["rmsnorm"] == 17 * (calls + n_nll),
          f"rmsnorm launches {counts['rmsnorm']} != 17 x ({calls} decode steps + {n_nll} NLLs)")
    check(counts["decode_attention"] == 4 * calls,
          f"decode_attention launches {counts['decode_attention']} != 4 x {calls}")
    check(counts["flash_attention"] == 4 * n_nll,
          f"flash_attention launches {counts['flash_attention']} != 4 layers x {n_nll} NLLs")
    if model_oracle:
        check(n_nll > 0, "the ModelOracle made no loss evaluation")
    cpu = serve_once(torch.device("cpu"), model_oracle)
    emit(summary(cpu, "cpu"))

    near_tie, max_dnll = (decision_parity(gpu["oracle"], cpu["oracle"]) if model_oracle
                          else (None, None))
    if near_tie is not None:
        emit({"phase": f"{phase}_parity", "near_tie": near_tie, "max_abs_dnll": max_dnll})
        return counts

    def nav(r):
        return (r.rid, r.trace.route, r.trace.llm_calls, r.trace.tool_calls, r.trace.pages_read,
                [(x.kind, x.path, x.text) for x in r.nav_results])
    check([nav(r) for r in gpu["done"]] == [nav(r) for r in cpu["done"]],
          "navigation traces differ between the card and the CPU")
    check(gpu["evidence"] == cpu["evidence"],
          "evidence answers differ between the card and the CPU")
    # greedy tokens: equal at every decode step, unless the CPU run's top-2
    # logit gap at the first differing step is below the f32 tolerance
    gpu_log, cpu_log = gpu["log"], cpu["log"]
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
        check(len(gpu_log) == len(cpu_log) and gpu["calls"] == cpu["calls"],
              "the two runs took different numbers of steps")
        check([r.answer for r in gpu["done"]] == [r.answer for r in cpu["done"]],
              "answers differ between the card and the CPU")
    min_gap = min((min(c[1][i] for i, on in enumerate(c[3]) if on)
                   for c in cpu_log if any(c[3])), default=None)
    out = {"phase": f"{phase}_parity", "decode_steps_compared": compared,
           "tokens_equal": near_tie is None, "near_tie": near_tie,
           "min_top2_gap_cpu": min_gap}
    if model_oracle:
        margins = [d[2] for d in cpu["oracle"]["decisions"] if d[2] is not None]
        routes = [r.trace.route for r in gpu["done"]]
        out.update(decisions_equal=True, max_abs_dnll=max_dnll,
                   flash_launches_per_nll=counts["flash_attention"] / n_nll,
                   min_decision_margin_cpu=min(margins, default=None),
                   routes={k: routes.count(k) for k in sorted(set(routes))},
                   needs_deeper_true=sum(1 for d in gpu["oracle"]["decisions"]
                                         if d[0] == "needs_deeper" and d[1]))
    emit(out)
    return counts


# ---------------------------------------------------------------------------
# phase 9: qwen3-1.7B prefill / eval at full width
# ---------------------------------------------------------------------------
def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def first_layers(params: dict, n: int) -> dict:
    """The same model cut to its first ``n`` layers (periods)."""
    return {**params, "body": tree_map(lambda t: t[:n], params["body"])}


def prefill_phase(dev, seed=0, seq=4096, parity_layers=2, parity_seq=256) -> dict:
    """qwen3-1.7B at full width with random weights from ``seed``: one
    make_prefill_step and one make_eval_step at B=1, S=``seq`` on the card
    (the launches counted), then their times; then logit parity of the
    first ``parity_layers`` layers at S=``parity_seq``, card against CPU,
    both held to the f32 computation of the same bf16 weights."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    host = M.init_params(cfg, seed=seed, device="cpu")
    t_init = time.perf_counter() - t0
    params = tree_map(lambda t: t.to(dev), host)
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(1, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((1, 1), -1, np.int32)], axis=1)
    batch = {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev)}
    prefill, evals = M.make_prefill_step(cfg), M.make_eval_step(cfg)

    # the main path: counts from zero, one prefill and one eval, read just after
    ops.reset_launches()
    logits = prefill(params, batch)
    loss = float(evals(params, batch))
    counts = dict(ops.LAUNCHES)
    n_norm = cfg.n_layers * (2 + 2 * int(cfg.qk_norm)) + 1
    check(counts["flash_attention"] == 2 * cfg.n_layers,
          f"flash_attention launches {counts['flash_attention']} != 2 forwards x {cfg.n_layers}")
    check(counts["rmsnorm"] == 2 * n_norm,
          f"rmsnorm launches {counts['rmsnorm']} != 2 forwards x {n_norm}")
    check(tuple(logits.shape) == (1, seq, cfg.padded_vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(math.isfinite(loss) and loss > 0, f"eval loss {loss}")
    del logits
    prefill_ms = cuda_ms(lambda: prefill(params, batch), iters=3, warmup=1)
    eval_ms = cuda_ms(lambda: evals(params, batch), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # where the time goes: one flash_attention and the norms of one layer at
    # the prefill shape (outside the count), times the layers
    gen = torch.Generator(device=dev).manual_seed(seed)
    act = getattr(torch, cfg.dtype)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((1, H, seq, Dh), generator=gen, device=dev).to(act)
    kv = torch.randn((2, 1, KV, seq, Dh), generator=gen, device=dev).to(act)
    flash_ms = cuda_ms(lambda: ops.attention(q, kv[0], kv[1], causal=True), iters=5, warmup=1)
    hid = torch.randn((seq, cfg.d_model), generator=gen, device=dev).to(act)
    w = torch.ones((cfg.d_model,), device=dev, dtype=act)
    wh = torch.ones((Dh,), device=dev, dtype=act)
    norm_ms = 2 * cuda_ms(lambda: ops.rmsnorm(hid, w))
    if cfg.qk_norm:
        norm_ms += cuda_ms(lambda: ops.rmsnorm(q.reshape(-1, Dh), wh))
        norm_ms += cuda_ms(lambda: ops.rmsnorm(kv[0].reshape(-1, Dh), wh))
    del q, kv, hid
    L = cfg.n_layers
    emit({"phase": "prefill", "arch": cfg.name, "layers": cfg.n_layers, "seq": seq,
          "init_s": t_init, "launches": counts,
          "flash_per_forward": counts["flash_attention"] // 2,
          "rmsnorm_per_forward": counts["rmsnorm"] // 2, "loss": loss,
          "prefill_ms": prefill_ms, "eval_ms": eval_ms,
          "prefill_tokens_per_s": seq / prefill_ms * 1e3, "peak_gib": peak,
          "prefill_breakdown_ms": {"flash_per_layer": flash_ms, "norms_per_layer": norm_ms,
                                   "flash": L * flash_ms, "norms": L * norm_ms,
                                   "rest": prefill_ms - L * (flash_ms + norm_ms)}})

    cfg_p = dataclasses.replace(cfg, n_layers=parity_layers)
    tb = {"tokens": torch.from_numpy(toks[:, :parity_seq])}
    card = M.make_prefill_step(cfg_p)(first_layers(params, parity_layers),
                                      {"tokens": tb["tokens"].to(dev)}).float().cpu()
    host_p = first_layers(host, parity_layers)
    cpu = M.make_prefill_step(cfg_p)(host_p, tb).float()
    cfg_32 = dataclasses.replace(cfg_p, dtype="float32", param_dtype="float32")
    f32 = M.make_prefill_step(cfg_32)(tree_map(lambda t: t.float(), host_p), tb)
    e_card, e_cpu = (card - f32).abs(), (cpu - f32).abs()
    out = {"phase": "prefill_parity", "layers": parity_layers, "seq": parity_seq,
           "max_abs_card_cpu": float((card - cpu).abs().max()),
           "max_abs_card_f32": float(e_card.max()), "max_abs_cpu_f32": float(e_cpu.max()),
           "mean_abs_card_f32": float(e_card.mean()), "mean_abs_cpu_f32": float(e_cpu.mean()),
           "max_abs_f32": float(f32.abs().max())}
    emit(out)
    # the tolerance: both runs round every matmul and norm output to bf16
    # in their own order, so neither equals the other bit for bit; the card
    # passes when its distance from the f32 computation is within twice
    # the CPU's own (in the max and in the mean)
    check(out["max_abs_card_f32"] <= 2 * out["max_abs_cpu_f32"]
          and out["mean_abs_card_f32"] <= 2 * out["mean_abs_cpu_f32"],
          f"card bf16 logits are further from the f32 computation than twice the CPU's: {out}")
    del params, host
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 10: the MoE path — moe_router, then dbrx-132b at full width
# ---------------------------------------------------------------------------
# (tag, T, E, k): dbrx prefill (S=4096) and decode (B=4), jamba, kimi-k2,
# and a ragged T
ROUTER_SHAPES = [("dbrx prefill", 4096, 16, 4), ("dbrx decode", 4, 16, 4),
                 ("jamba", 4096, 16, 2), ("kimi-k2", 4096, 384, 8), ("ragged", 4099, 16, 4)]
ROUTER_NEAR_TIE = 1e-6   # two candidates' probabilities this close may order either way


def router_library(logits, k):
    """softmax -> topk -> renorm, three PyTorch calls (the yardstick only)."""
    import torch
    w, idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    return w / w.sum(dim=-1, keepdim=True), idx


def router_kernels(dev) -> dict:
    """(a) moe_router against its plain version at ROUTER_SHAPES, with
    renormalize on and off, on random-normal and on tie-laden logits (a
    grid of 0.5).  Indices equal in every tie-laden row; on normal input a
    row may differ only where two of its k + 1 largest probabilities lie
    within ROUTER_NEAR_TIE (counted); weights within 1e-6 on the rows that
    agree.  Timed beside its bytes bound, the plain version and the
    library composite."""
    import torch
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cpu").manual_seed(2)
    rows, near_rows = [], 0
    for tag, T, E, k in ROUTER_SHAPES:
        x = torch.randn((T, E), generator=g).to(dev) * 2
        err = 0.0
        for kind, logits in (("normal", x), ("ties", torch.round(x * 2) / 2)):
            for renorm in (True, False):
                w, idx = ops.moe_router(logits, k, renormalize=renorm)
                pw, pidx = ref.moe_router_ref(logits, k, renormalize=renorm)
                differ = (idx != pidx).any(dim=1)
                p = torch.softmax(logits.double(), dim=-1).sort(dim=-1, descending=True).values
                near = (p[:, :k] - p[:, 1:k + 1]).amin(dim=-1) < ROUTER_NEAR_TIE
                check(kind == "normal" or not bool(differ.any()),
                      f"moe_router ({tag}, ties): indices differ in {int(differ.sum())} rows")
                check(not bool((differ & ~near).any()),
                      f"moe_router ({tag}): indices differ beyond a near tie")
                near_rows += int(differ.sum())
                err = max(err, max_err(w[~differ], pw[~differ]))
                check(err <= 1e-6, f"moe_router ({tag}): weights differ by {err}")
        # bytes: the logits read once, weights and indices written once;
        # operations: exp, subtract and divide per logit, k compare rounds
        b, by = bound(T * E * 4 + T * k * 8, T * E * (3.0 + k), F32_FLOPS)
        gm = graph_ms(mr.moe_router, (x, k))
        one_kernel_a_call(f"moe_router ({tag})", gm)
        rows.append({"shape": f"({tag}) T={T} E={E} k={k} float32 renormalized",
                     "geometry": dict(zip(("tokens_a_warp", "v", "blocks"),
                                          mr.router_geometry(T, E))),
                     "max_abs_err": err, "ms": cuda_ms(lambda: mr.moe_router(x, k)),
                     "device_ms": gm["device_ms"],
                     "host_ms": host_ms(lambda: mr.moe_router(x, k)),
                     "plain_ms": cuda_ms(lambda: ref.moe_router_ref(x, k)),
                     "library_ms": cuda_ms(lambda: router_library(x, k)),
                     "library_device_ms": graph_ms(router_library, (x, k))["device_ms"],
                     "library_host_ms": host_ms(lambda: router_library(x, k)),
                     "bound_ms": b, "bound_by": by})
    emit({"phase": "moe_router", "shapes": rows, "rows_differing_at_near_ties": near_rows,
          "library": "softmax -> topk -> renorm (three calls)"})
    return {"moe_router": {"name": "moe_router", "route": "cuda",
                           "source": "src/repro_torch/kernels/csrc/moe_router.cu",
                           "replaces": "src/repro/kernels/moe_router.py:55",
                           **rows[0], "shapes": rows[1:]}}


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def logged_run(fn):
    """``fn()`` with every ``ops.moe_router`` call's (f32 logits, indices)
    recorded on the host; returns (result, log)."""
    from repro_torch.kernels import ops
    log, orig = [], ops.moe_router

    def logged(logits, k, **kw):
        w, idx = orig(logits, k, **kw)
        log.append((logits.float().cpu(), idx.cpu()))
        return w, idx
    ops.moe_router = logged
    try:
        return fn(), log
    finally:
        ops.moe_router = orig


def first_flip(ref_log, other_log, k) -> dict | None:
    """The first (layer, token) whose router indices differ between two
    runs, checked to be a near tie: in the reference run's logits of that
    token, two of the k + 1 largest lie within the two runs' rounding
    difference of that row (max |d logit|).  None when all are equal.
    Tokens before it are unaffected in every layer (causal attention)."""
    import torch
    for layer, ((lr, ir), (lo, io)) in enumerate(zip(ref_log, other_log)):
        rows = torch.nonzero((ir != io).any(dim=1)).flatten()
        if rows.numel():
            t = int(rows[0])
            top = lr[t].sort(descending=True).values[:k + 1]
            gap = float((top[:-1] - top[1:]).min())
            rounding = float((lr[t] - lo[t]).abs().max())
            check(gap <= rounding, f"router layer {layer} token {t}: experts "
                  f"{ir[t].tolist()} vs {io[t].tolist()} with a logit gap {gap} > {rounding}")
            return {"layer": layer, "token": t, "tokens_differing": int(rows.numel()),
                    "logit_gap": gap, "rounding": rounding}
    return None


def host_mem_available() -> int:
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def moe_phase(dev, seed=0, layers=8, seq=4096, dec_batch=4, dec_len=512, dec_steps=16,
              parity_seq=128, tf_tokens=16) -> dict:
    """(b) dbrx-132b at full width (depth cut to ``layers`` of 40 to fit
    one card), weights drawn on the card from ``seed``: one prefill and
    one eval at B=1, S=``seq``, then ``dec_steps`` serve steps at
    B=``dec_batch``, max_len ``dec_len`` — the launches counted — then
    their times beside their bounds.  (c) the first 2 layers (1 when the
    host is short of memory) upcast to f32 on the card and on the CPU at
    S=``parity_seq``: router indices equal but at near ties, logits within
    1e-3 of the largest; the bf16 run's share of assignments whose expert
    differs from the f32 run; and teacher-forced decode of ``tf_tokens``
    tokens against the prefill logits at capacity_factor 64."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T
    full = get_config("dbrx-132b")
    cfg = dataclasses.replace(full, n_layers=layers)
    m = cfg.moe
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(1, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((1, 1), -1, np.int32)], axis=1)
    batch = {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev)}
    prefill, evals, serve = M.make_prefill_step(cfg), M.make_eval_step(cfg), M.make_serve_step(cfg)
    state = T.init_decode_state(cfg, dec_batch, dec_len, dev)
    tk = torch.from_numpy(rs.randint(0, cfg.vocab, size=dec_batch).astype(np.int32)).to(dev)
    lens0 = [0, dec_len // 5, dec_len // 2, dec_len - dec_steps]
    lens = torch.tensor(lens0, dtype=torch.int32, device=dev)

    # the main path: counts from zero, one prefill, one eval and the decode
    # steps, read just after
    ops.reset_launches()
    logits, log_pre = logged_run(lambda: prefill(params, batch))
    loss = float(evals(params, batch))
    check(tuple(logits.shape) == (1, seq, cfg.padded_vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite dbrx prefill logits")
    check(math.isfinite(loss) and loss > 0, f"dbrx eval loss {loss}")
    del logits
    fwd = dict(ops.LAUNCHES)
    for _ in range(dec_steps):
        tk, dec_logits, state = serve(params, state, {"tokens": tk, "lengths": lens})
        lens = lens + 1
    check(bool(torch.isfinite(dec_logits[:, :cfg.vocab]).all()), "non-finite decode logits")
    counts = dict(ops.LAUNCHES)
    dec = {k: counts[k] - fwd[k] for k in counts}
    n_norm = 2 * layers + 1
    for name, per_fwd, per_step in (("moe_router", layers, layers),
                                    ("flash_attention", layers, 0),
                                    ("decode_attention", 0, layers),
                                    ("rmsnorm", n_norm, n_norm)):
        check(fwd[name] == 2 * per_fwd and dec[name] == dec_steps * per_step,
              f"{name} launches {fwd[name]} (2 forwards) / {dec[name]} ({dec_steps} decode "
              f"steps) != {2 * per_fwd} / {dec_steps * per_step}")

    prefill_ms = cuda_ms(lambda: prefill(params, batch), iters=3, warmup=1)
    eval_ms = cuda_ms(lambda: evals(params, batch), iters=3, warmup=1)
    step = {"tokens": tk, "lengths": lens - 1}      # the last step again, in place
    _, log_dec = logged_run(lambda: serve(params, state, step))
    decode_ms = cuda_ms(lambda: serve(params, state, step), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # where the time goes: one layer's MoE FFN at the prefill and decode
    # shapes, one flash_attention at the prefill shape (outside the count)
    layer0 = tree_map(lambda t: t[0], params["body"]["slot0"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    act = getattr(torch, cfg.dtype)
    h = torch.randn((seq, cfg.d_model), generator=gen, device=dev).to(act)
    moe_ms = cuda_ms(lambda: MoE.moe_apply_local(layer0["moe"], h, cfg), iters=5, warmup=1)
    moe_dec_ms = cuda_ms(lambda: MoE.moe_apply_local(layer0["moe"], h[:dec_batch], cfg),
                         iters=10, warmup=2)
    q = torch.randn((1, cfg.n_heads, seq, cfg.head_dim), generator=gen, device=dev)
    kv = torch.randn((2, 1, cfg.n_kv_heads, seq, cfg.head_dim), generator=gen, device=dev)
    q, kv = q.to(act), kv.to(act)
    flash_ms = cuda_ms(lambda: ops.attention(q, kv[0], kv[1], causal=True), iters=5, warmup=1)
    del h, q, kv, layer0
    # bounds.  Prefill: operations (the projections, causal attention, the
    # head, the experts); a decode step: bytes (every weight but the
    # embedding and the unrouted experts, the live KV cache).  The
    # function's bound counts the expert work this run's routing needs:
    # the (token, expert) assignments kept under capacity in prefill, the
    # experts routed to at least once in the timed decode step.  The
    # dispatch bound counts what the capacity dispatch computes and reads:
    # every (expert, capacity slot), every expert.
    D, H, KV, Dh, V = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.padded_vocab
    E, F_ = m.n_experts, m.d_ff_expert
    cap = MoE._capacity(seq, m.top_k, E, m.capacity_factor)
    cap_dec = MoE._capacity(dec_batch, m.top_k, E, m.capacity_factor)
    kept = sum(int(torch.bincount(idx.flatten().long(), minlength=E).clamp(max=cap).sum())
               for _, idx in log_pre)
    routed = [len(set(idx.flatten().tolist())) for _, idx in log_dec]
    check(len(log_pre) == len(log_dec) == layers, "router calls per forward / step != layers")
    dense = layers * (2 * seq * D * (2 * H * Dh + 2 * KV * Dh) + 2 * seq * D * E
                      + 4.0 * Dh * H * seq * (seq + 1) / 2) + 2 * seq * D * V
    expert_flops = 3 * 2 * D * F_               # one (token, expert) assignment
    flops = dense + expert_flops * kept
    flops_dispatch = dense + expert_flops * layers * E * cap
    b_pre, by_pre = bound(w_bytes, flops, BF16_FLOPS)
    b_pre_d, by_pre_d = bound(w_bytes, flops_dispatch, BF16_FLOPS)
    expert_bytes = 3 * D * F_ * torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    emb_bytes = params["embed"].numel() * params["embed"].element_size()
    kv_bytes = 2 * layers * KV * Dh * 2 * sum(n + dec_steps for n in lens0)
    rest_bytes = w_bytes - emb_bytes - layers * E * expert_bytes + kv_bytes
    b_dec, by_dec = bound(rest_bytes + expert_bytes * sum(routed),
                          expert_flops * layers * dec_batch * m.top_k, BF16_FLOPS)
    b_dec_d, by_dec_d = bound(rest_bytes + expert_bytes * layers * E,
                              expert_flops * layers * E * cap_dec, BF16_FLOPS)
    emit({"phase": "moe", "arch": cfg.name, "layers": layers, "of": full.n_layers,
          "params_b": n_params / 1e9, "weights_gib": w_bytes / 2**30, "init_s": t_init,
          "seq": seq, "loss": loss, "launches": counts,
          "per_forward": {k: fwd[k] // 2 for k in ("moe_router", "flash_attention", "rmsnorm")},
          "per_decode_step": {k: dec[k] // dec_steps
                              for k in ("moe_router", "decode_attention", "rmsnorm")},
          "prefill_ms": prefill_ms, "prefill_tokens_per_s": seq / prefill_ms * 1e3,
          "eval_ms": eval_ms, "decode_batch": dec_batch, "decode_step_ms": decode_ms,
          "peak_gib": peak, "capacity_per_expert": cap,
          "prefill_assignments_kept": kept, "prefill_tflop": flops / 1e12,
          "prefill_bound_ms": b_pre, "prefill_bound_by": by_pre,
          "prefill_dispatch_tflop": flops_dispatch / 1e12,
          "prefill_dispatch_bound_ms": b_pre_d, "prefill_dispatch_bound_by": by_pre_d,
          "decode_experts_routed": routed,
          "decode_gb": (rest_bytes + expert_bytes * sum(routed)) / 1e9,
          "decode_bound_ms": b_dec, "decode_bound_by": by_dec,
          "decode_dispatch_gb": (rest_bytes + expert_bytes * layers * E) / 1e9,
          "decode_dispatch_bound_ms": b_dec_d, "decode_dispatch_bound_by": by_dec_d,
          "prefill_breakdown_ms": {"moe_ffn_per_layer": moe_ms, "flash_per_layer": flash_ms,
                                   "moe_ffn": layers * moe_ms, "flash": layers * flash_ms,
                                   "rest": prefill_ms - layers * (moe_ms + flash_ms)},
          "decode_breakdown_ms": {"moe_ffn_per_layer": moe_dec_ms, "moe_ffn": layers * moe_dec_ms,
                                  "rest": decode_ms - layers * moe_dec_ms}})

    # (c) parity on the first layers, the rest of the card's weights freed
    f32_bytes = 2 * (w_bytes / layers * 2 + 2 * emb_bytes)
    n_par = 2 if host_mem_available() >= 1.5 * f32_bytes else 1
    small = {**params, "body": tree_map(lambda t: t[:n_par].clone(), params["body"])}
    del params, state, dec_logits, step
    torch.cuda.empty_cache()
    cfg_p = dataclasses.replace(cfg, n_layers=n_par)
    cfg32 = dataclasses.replace(cfg_p, dtype="float32", param_dtype="float32")
    cfg64 = dataclasses.replace(cfg32, moe=dataclasses.replace(m, capacity_factor=64.0))
    fwd32 = M.make_prefill_step(cfg32)
    tokens = torch.from_numpy(toks[:, :parity_seq])
    _, log_bf = logged_run(lambda: M.make_prefill_step(cfg_p)(small, {"tokens": tokens.to(dev)}))
    card32_p = tree_map(lambda t: t.float(), small)
    del small
    torch.cuda.empty_cache()
    card, log_card = logged_run(lambda: fwd32(card32_p, {"tokens": tokens.to(dev)}).cpu())
    host32 = tree_map(lambda t: t.cpu(), card32_p)
    t0 = time.perf_counter()
    cpu, log_cpu = logged_run(lambda: fwd32(host32, {"tokens": tokens}))
    cpu_s = time.perf_counter() - t0
    del host32
    # teacher-forced decode against the prefill at capacity_factor 64
    tf = tokens[:, :tf_tokens].to(dev)
    tf_full, log_tf_full = logged_run(
        lambda: M.make_prefill_step(cfg64)(card32_p, {"tokens": tf}).cpu())

    def decode_all():
        st, out = T.init_decode_state(cfg64, 1, tf_tokens, dev), []
        with torch.inference_mode():
            for t in range(tf_tokens):
                lg, st = T.decode_step(card32_p, st, tf[:, t],
                                       torch.full((1,), t, dtype=torch.int32, device=dev), cfg64)
                out.append(lg.cpu())
        return torch.stack(out, dim=1)
    got, log_tf_dec = logged_run(decode_all)
    del card32_p
    torch.cuda.empty_cache()

    k = m.top_k
    flip = first_flip(log_cpu, log_card, k)
    upto = parity_seq if flip is None else flip["token"]
    scale = float(cpu.abs().max())
    err = float((card[0, :upto] - cpu[0, :upto]).abs().max()) if upto else 0.0
    check(err <= 1e-3 * scale, f"f32 logits card vs cpu differ by {err} > 1e-3 x {scale}")
    changed = total = 0
    for (_, i32), (_, ibf) in zip(log_card, log_bf):
        for a, b in zip(i32.tolist(), ibf.tolist()):
            changed += len(set(b) - set(a))
            total += len(a)
    # decode: one router call per layer per step (T=1); regroup as the
    # prefill's (layer, token) rows
    dec_log = [(torch.cat([log_tf_dec[t * n_par + layer][0] for t in range(tf_tokens)]),
                torch.cat([log_tf_dec[t * n_par + layer][1] for t in range(tf_tokens)]))
               for layer in range(n_par)]
    tf_flip = first_flip(log_tf_full, dec_log, k)
    tf_upto = tf_tokens if tf_flip is None else tf_flip["token"]
    tf_scale = float(tf_full.abs().max())
    tf_err = float((got[0, :tf_upto] - tf_full[0, :tf_upto]).abs().max()) if tf_upto else 0.0
    check(tf_err <= 1e-3 * tf_scale,
          f"teacher-forced decode vs prefill differ by {tf_err} > 1e-3 x {tf_scale}")
    emit({"phase": "moe_parity", "layers": n_par,
          "layers_note": None if n_par == 2 else "1 layer: the host is short of memory",
          "seq": parity_seq, "dtype": "float32 (bf16 weights upcast)", "cpu_forward_s": cpu_s,
          "max_abs_card_cpu": err, "max_abs_logit": scale, "tolerance": 1e-3 * scale,
          "router_near_tie": flip, "tokens_compared": upto,
          "bf16_assignments_changed": changed, "bf16_assignments": total,
          "bf16_share_changed": changed / max(total, 1),
          "teacher_forced": {"tokens": tf_tokens, "capacity_factor": 64.0,
                             "max_abs_decode_prefill": tf_err, "max_abs_logit": tf_scale,
                             "router_near_tie": tf_flip, "tokens_compared": tf_upto}})
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
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          # two CUDA events around nothing: the least any row's ms can read
          "event_floor_ms": cuda_ms(lambda: None)})
    t0 = time.perf_counter()
    nvcc_s = build.build_all()
    t_cuda = time.perf_counter() - t0
    emit({"phase": "build", "nvcc_s": nvcc_s, "cuda_build_s": t_cuda,
          "ptxas": {n: [ln.strip() for ln in (build.BUILD_DIR / f"{n}.log").read_text()
                        .splitlines() if "registers" in ln or "spill" in ln][:24]
                    for n in build.SOURCES if (build.BUILD_DIR / f"{n}.log").exists()}})

    entries = model_kernels(dev)
    entries.update(attention_kernels(dev))
    entries.update(router_kernels(dev))

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

    # each path below sets the counts to 0 just before it and reads them just after
    path_counts = [query_counts, serving_phase(dev), serving_phase(dev, model_oracle=True),
                   prefill_phase(dev), moe_phase(dev)]

    kernels = []
    for name in ("path_lookup", "prefix_search", "rmsnorm", "decode_attention",
                 "flash_attention", "moe_router"):
        e = entries[name]
        e["launches"] = sum(c[name] for c in path_counts)
        check(e["launches"] > 0, f"{name} was never launched on the main path")
        kernels.append({k: e[k] for k in ("name", "route", "source", "replaces", "launches",
                                          "max_abs_err", "ms", "device_ms", "host_ms",
                                          "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "library_device_ms", "library_host_ms", "shape",
                                          "geometry", "shapes")
                        if k in e})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

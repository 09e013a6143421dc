#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout and drives
its main path on the card, printing one JSON line per phase:

  1. environment: torch/CUDA versions, the card, the kernel build, and
     the floor of one kernel node under ``device_ms``'s instrument (a
     one-element op in a captured graph, inputs rotated);
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
  6. the durable tier (``durable``): a child process builds the same
     wiki at 2^16 files into a 4-shard durable store (WAL fsync at every
     commit), mirrors it in a DeviceEngine on the card, commits a patched
     write wave and wave A, flushes wave B uncommitted and exits with no
     close; this process reopens the directory, rehydrates a DeviceEngine
     on the card from the WAL's journal (wave A present, wave B lost, the
     committed epoch), drives the waves against a HostEngine over the
     reopened store, commits one more wave and reopens once more with
     nothing pending; then the wikikv-router serving loop over a durable
     AuthTrace wiki, restarted from disk between two halves of its
     requests, equal to the same run on the CPU and to an uninterrupted
     run over a MemKV store;
  7. the wikikv-router serving loop at full width over the AuthTrace wiki
     on the card, against the same run on the CPU (plain versions);
  8. flash_attention against its plain version at the oracle's, qwen3
     prefill, chunked-prefill, non-causal ragged and group-6 shapes, and
     kimi-k2's head_dim 112 (its prefill, 64 / 8 heads, and a ragged f32
     shape), timed beside the plain version and SDPA;
  9. LM-routed navigation: the same serving run with a wikikv-router
     ModelOracle (two loss evaluations per decision, flash_attention in
     every layer) on the card and on the CPU, decisions and traces equal;
 10. qwen3-1.7B at full width (28 layers, random weights from the seed):
     make_prefill_step and make_eval_step at B=1, S=4096 on the card,
     launches per forward, a finite loss, and logit parity with the CPU
     at 2 layers and S=256;
 11. moe_router against its plain version at the dbrx prefill and decode,
     jamba, kimi-k2 and ragged shapes (tie-laden logits too), timed beside
     the plain version and the softmax -> topk -> renorm composite (the
     card's own time, the host's, one kernel node a call), and its
     backward kernel moe_router_bwd at the dbrx, jamba, kimi-k2 and
     ragged training shapes, renormalized and not, beside the composite's
     autograd backward; then
     dbrx-132b at full width (8 of its 40 layers, weights drawn on the
     card from the seed): make_prefill_step and make_eval_step at B=1,
     S=4096 and 16 make_serve_step decode steps at B=4, launches per
     forward and per step, times beside their bounds; f32 parity of its
     first 2 layers with the CPU (router indices, logits), the bf16 run's
     share of changed expert assignments, and teacher-forced decode
     against the prefill; then kimi-k2-1t-a32b at full width (2 of its 61
     layers: the dense prefix layer and one MoE layer with all 384
     experts and the shared expert, ~39.5 GB drawn on the card, head_dim
     112) through the same prefill, eval and 16 decode steps, launches
     checked exactly, and the f32 parity of a reduced kimi at head_dim
     112 with 384 experts;
 12. the SSM and xLSTM families: jamba-v0.1-52b at full width (one
     period, 8 of its 32 layers: mamba, attention and MoE slots, weights
     drawn on the card) and xlstm-350m at full width (one period, 8 of its
     24 mLSTM and sLSTM layers):
     make_prefill_step and make_eval_step at B=1, S=4096 and 16
     make_serve_step decode steps at B=4 (ragged lengths), launches per
     forward and per step checked exactly, times beside their bounds, the
     prefill split into the scans (mamba, mLSTM, sLSTM per layer, timed
     alone) and the rest; then f32 parity with the CPU: jamba cut to its
     period's first four slots at S=128 (logits, router indices but at
     near ties, teacher-forced decode against the prefill), xlstm's 8
     layers at S=512 (two mLSTM chunks) layer by layer (each layer's prefill
     and 16 decode steps on the CPU's input to it, the decode against
     the prefill), end to end through the final norm and head over its
     first layers while the card's own logits moved by a 1e-7
     perturbation of the embeddings stay within 2.5e-4 of the largest, and
     at full depth the card-CPU distance within 10x that witness, since
     its layers amplify rounding; and each of the two cut models, on the
     same weights, through the ServingEngine (``recurrent_serving``): 8
     AuthTrace requests at B=4, max_len 512, prompts cut to 32 tokens,
     over a DeviceEngine on the card with the heuristic oracle, launches
     per serve call and per engine wave checked exactly, then each request
     alone on a fresh engine: at B=4 its logits equal the batched run's
     bit for bit, at B=1 bf16 rounding flips are reported through
     ``first_flip``; decode step ms, prefill ms a prompt token, requests/s;
 13. the encoder-decoder and vision paths: whisper-medium at full width
     and depth (24 encoder and 24 decoder layers, weights drawn on the
     card) over 1500 frames and 448 tokens at B=4, make_prefill_step and
     make_eval_step, the encoder's output, and 16 make_serve_step decode
     steps given it (each recomputes the cross-attention's keys and values
     over the 1500 frames, as the reference does); internvl2-1b at full
     width and depth (24 layers, 14 / 2 heads) over 256 patch embeddings
     and 3840 tokens at B=1, and 16 text-only decode steps at B=4
     (decode_attention at group 7); launches per forward and per step
     checked exactly, times beside their bounds, peak memory; then f32
     parity with the CPU on 2 (+ 2 encoder) layers at full width: whisper
     at 256 frames / 64 tokens and at 64 frames / 128 tokens (more queries
     than keys in the cross-attention), internvl2 at 256 + 128 positions,
     each with teacher-forced decode against the prefill (internvl2's
     against the prefill without the prefix, which the reference's decode
     never sees);
 14. the training path: flash_attention_bwd and rmsnorm_bwd against their
     plain versions at every train step's shapes (the router's, qwen3's,
     dbrx's group of 6, jamba's 32 / 8 heads of 128, internvl2's 14 / 2 of
     64 at 4096, whisper's encoder, decoder and cross-attention at B=4),
     a ragged one, and two non-causal Sq > Skv (1500 queries over
     448 keys at whisper's heads in bf16, 200 over 77 in f32; the norms at
     each model's width and rows, qwen3's qk-norm, one without scale),
     timed beside the autograd backward of
     SDPA and ``F.rms_norm`` (each row with its launch geometry; a bf16
     flash_attention_bwd call is two kernel nodes, the delta pre-pass and
     the wgmma body, an f32 call one, an rmsnorm_bwd call one with or
     without a scale); wikikv-router at full width trained by a
     TrainLoop on the AuthTrace pipeline (B=8, S=128) for 20 steps on the
     card and on the CPU, losses equal within 2e-3 and falling, then a
     crash at step 8 and a restart that ends bit for bit where an
     uninterrupted 12-step run ends; qwen3-1.7B at full width (28 layers,
     bf16, f32 AdamW moments, B=1, S=4096) for 5 train steps on one batch,
     a falling loss, step ms, tokens/s, peak memory, launches per step and
     the model FLOPs' share of the bf16 peak, and f32 parity of its first
     2 layers' loss and gradients with the CPU at S=256; dbrx-132b at full
     width cut to 1 of its 40 layers (bf16, bf16 AdamW moments, B=1,
     S=4096) for 3 train steps, one moe_router_bwd a MoE layer a step,
     and a reduced dbrx's f32 loss and gradients, the router's included,
     card against CPU; then the other families, each with its launches a
     step checked exactly against ``train_launches``, finite losses, step
     ms with its device split, tokens/s, peak memory, the eager AdamW
     update alone and its cuts: xlstm-350m at full width, 8 of its 24
     layers (B=1, S=2048, 2 steps; one sLSTM and one mLSTM layer's forward and backward
     timed alone) with a reduced xlstm's f32 gradients against the CPU
     within twice the card's own witness; jamba-v0.1-52b at full width cut
     to one period (8 of 32 layers) and 2 of its 16 experts (~3.9 B
     parameters, bf16 moments, B=1, S=4096, 3 steps; the selective scan
     through its autograd Function, one mamba layer timed alone) with a
     reduced jamba's (4 experts top 2, two scan chunks) f32 gradients
     against the CPU; whisper-medium at full width and depth (B=4, 1500
     frames and 448 tokens, 3 steps: 72 flash_attention_bwd a step);
     internvl2-1b (256 patch embeddings + 3840 tokens, 3 steps); and f32
     gradient parity of a reduced whisper at 64 frames / 128 tokens (the
     cross-attention's backward at more queries than keys) and 256 / 64,
     and of a reduced internvl2 at 8 + 128; kimi-k2 at full width cut to
     its dense prefix layer and one MoE layer of 32 of its 384 experts
     (~4.3 B, int8 AdamW moments, B=1, S=4096, 3 steps) with a reduced
     kimi's f32 gradients at head_dim 112 against the CPU;
     decode_scores and decode_combine, the head_dim layout's decode, with
     the ranks' slices of head_dim emulated on the card (qwen3-1.7B at 2
     and 16 ranks, dbrx-132b's group of 6, kimi-k2's slice of 7 columns,
     internvl2-1b's of 4, the router in f32): each slice against the
     plain versions, the joined output against decode_attention, timed
     beside the plain versions and a library call;
 15. the mesh over torch.distributed on one rank (NCCL): the router's
     meshed train step on a (1, 1) mesh (each layer gathered on use, each
     period checkpointed) against the unmeshed step bit for bit over 3
     steps, its launches the unmeshed step's and the recompute's,
     ``pipeline_apply`` with one stage against the stage,
     ``restore_elastic`` onto the mesh bit for bit, its loss and
     gradients under ``REPRO_REMAT_POLICY=dots`` bit for bit those under
     "nothing" with fewer products run (both peaks printed); the meshed prefill
     (B=4, S=4096) and 16 meshed serve steps (B=4, from an empty cache) of
     the wikikv-router, qwen3-1.7B (28 layers) and dbrx-132b (1 of 40
     layers) against the unmeshed steps, logits bit for bit, tokens equal,
     launches equal, their ms printed beside the card's name and power
     limit, and dbrx's expert-parallel body against the local MoE; the dry
     run's predicted memory of qwen3-1.7B's one-rank remat'd train step
     (B=1, S=4096; traced in a child process on a fake group) within
     [0.85, 1.15] of the card's ``max_memory_allocated``; then the
     head_dim layout's meshed decode (qwen3-1.7B at full width, 4 of its
     28 layers, f32) over two "model" ranks run as threads on the card
     (PyTorch's threaded process group; NCCL takes one rank a card): 8
     serve steps through decode_scores, the all-reduce of the partial
     scores and decode_combine against the unmeshed steps, the caches'
     blocks against the unmeshed cache, launches exact;
 16. the dry run (``python -m repro_torch.launch.dryrun``, a child process
     a cell, 8 at once) on fake "cuda" over a fake 256- or 512-rank group:
     qwen3, dbrx, whisper and internvl2 at train_4k and decode_32k,
     codeqwen1.5-7b at both, jamba, xlstm and olmo-1b at decode_32k on
     16x16, kimi-k2 at train_4k on 2x16x16, every cell ok, one line each;
     qwen3's and codeqwen's train_4k under 80 GiB a card (qwen3's useful
     share of the FLOPs at least 0.25), codeqwen's, olmo's and whisper's
     decode_32k moving at most a tenth of the collective bytes of the
     whole-model gather's, and qwen3's (dbrx's) decode_32k at most a
     fifth (a third) of the bytes its layers' cache gathers moved before
     the head_dim layout decoded over its slices (DRYRUN_LIMITS); dbrx's
     train_4k and qwen3's
     decode_32k also on fake "cpu" (the plain versions), with the same
     cost, collectives and memory;
 17. one JSON line of every kernel (eleven) with its launches, error, times
     and bound; the card's name and power limit; the final
     ``{"ok": true, ...}``.

Every check that fails raises, and the script then exits non-zero with no
final line.  It needs a card (it exits non-zero when CUDA is not
available) and the rest of the checkout (it exits non-zero when run from
a directory that holds only this file).  It imports nothing of JAX.  The
durable phase needs 4 GB free in the temporary directory (the store takes
about 0.7 GB) and runs its crash half as ``chip_smoke.py --durable-child
ROOT SCALE_LOG2`` in a process of its own.
"""
from __future__ import annotations

import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
BF16_FLOPS = 989e12        # bfloat16 on the tensor cores
INT8_OPS = 1979e12
# exponentials a second on an H100 SXM5's special-function units (the
# FlashAttention-3 paper's 3.9 TFLOP/s of them beside 989 of bf16 products)
EXP_PER_S = 3.9e12
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

SCALE_LOG2 = 20            # 2^20 files in the synthetic wiki
# the durable phase's wiki: a sixteenth of the query phase's, so that the
# whole smoke keeps well inside its time limit with the mesh and dry-run
# phases (its ingest with an fsync a commit and two from_store freezes
# took ~380 s at 2^20, and 207 s at 2^19 on an H100 host that ran the
# smoke in 1,078 s; the phase took 167 s at 2^17 on a host that ran the
# smoke in ~1,210 s)
DURABLE_SCALE_LOG2 = 16
N_DIMS, N_TOPICS = 16, 256


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "at_s": time.perf_counter() - T_START}), flush=True)


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


def device_events(prof) -> list:
    """(name, count, device us) of each kernel and copy a ``torch.profiler``
    run put on the card.  Only the device's own events count: an operator's
    row on the host carries the time of the kernels it launched as its
    "self" device time too, so summing every row would count each kernel
    twice (the profiler's own table sums the device rows alone).  Read
    from the profiler's raw events: the table of parsed events
    (``key_averages``) of a host-bound train step of ~10^6 kernels takes
    minutes to build, and holds the same sums."""
    from torch.autograd import DeviceType
    agg: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() or e.duration_ns() <= 0:
            continue
        n, us = agg.get(e.name(), (0, 0.0))
        agg[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return [(k, n, us) for k, (n, us) in agg.items()]


def profiled_ms(fn, inputs, calls: int) -> float | None:
    """Device time of one call ``fn(*inputs)`` in ms from ``torch.profiler``
    over ``calls`` eager calls (``device_events``); None where the profiler
    shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*inputs)
        torch.cuda.synchronize()
    us = sum(t for _, _, t in device_events(prof))
    return us / 1e3 / calls if us > 0 else None


# a kernel's category is the first whose name fragment its name contains
# (the backward's kernels: flash_bwd_kernel, flash_bwd_delta_kernel and
# flash_bwd_wgmma_kernel; rmsnorm_bwd_kernel)
STEP_CATEGORIES = (("flash_attention_bwd", ("flash_bwd",)),
                   ("flash_attention", ("flash_fwd",)),
                   ("rmsnorm_bwd", ("rmsnorm_bwd",)),
                   ("rmsnorm", ("rmsnorm",)),
                   ("matmul", ("gemm", "nvjet", "xmma", "cutlass")))


def device_split(fn, untraced_ms: float) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's busy ms (its
    kernels and copies, on one stream, so they do not overlap), its idle
    share of ``untraced_ms`` (the same work timed without the profiler,
    whose host tracing lengthens a step), and the busy ms by
    STEP_CATEGORIES ("other": elementwise, reductions, the optimizer,
    copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {name: 0.0 for name, _ in STEP_CATEGORIES}
    split["other"] = 0.0
    for key, _, us in device_events(prof):
        cat = next((name for name, frags in STEP_CATEGORIES
                    if any(f in key.lower() for f in frags)), "other")
        split[cat] += us / 1e3
    busy = sum(split.values())
    return {"busy_ms": busy, "untraced_ms": untraced_ms,
            "idle_share": max(0.0, 1.0 - busy / untraced_ms), "busy_ms_by_kind": split}


def graph_ms(fn, inputs, calls: int = 32, replays: int = 5, warmup: int = 3,
             rotate: bool = True) -> dict:
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
    (or None) and the reason, which is also printed.  ``rotate=False``
    gives every call the same inputs (warm in L2 after the first)."""
    import torch
    from repro_torch.kernels import build
    nbytes = sum(t.numel() * t.element_size() for t in inputs if isinstance(t, torch.Tensor))
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    n_copies = max(1, min(calls, -(-2 * l2 // max(nbytes, 1)))) if rotate else 1
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


def one_kernel_a_call(name: str, gm: dict, kernels: int = 1) -> None:
    """Fail unless ``gm`` (from ``graph_ms``) captured its calls and each
    made exactly ``kernels`` kernel nodes and no other node."""
    check(gm["by"] == "cuda graph"
          and gm["kernel_nodes"] == gm["nodes"] == gm["calls"] * kernels,
          f"{name}: {gm}; not {kernels} kernel node(s) a call")


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
    max_len 512), the longer-cache shapes, qwen3-1.7B's prefill norms,
    dbrx-132b's (d_model 6144; decode at group 6: 48 query heads, 8 KV
    heads, head_dim 128, B=4, max_len 512), jamba-v0.1-52b's (d_model
    4096; decode at group 4: 32 / 8 heads, head_dim 128), xlstm-350m's
    norms (d_model 1024), whisper-medium's (d_model 1024: 1792 decoder and
    6000 encoder rows at B=4; decode at group 1, 16 / 16 heads, head_dim
    64, max_len 448), internvl2-1b's (d_model 896; decode at group 7,
    14 / 2 heads, head_dim 64, max_len 512) and kimi-k2's (d_model 7168;
    decode at group 8, 64 / 8 heads, head_dim 112, max_len 4096); returns
    the JSON entries."""
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
    # the block norms of dbrx-132b, jamba-v0.1-52b and xlstm-350m at S=4096
    # and at a decode step of B=4; whisper-medium's decoder (4 x 448 rows)
    # and encoder (4 x 1500), internvl2-1b's prefill (256 + 3840 rows) and
    # decode step, kimi-k2's (d_model 7168) at S=4096 and at B=4
    shapes = []
    for rows, D in ((4096, 2048), (4096 * 16, 128), (4096, 6144), (4, 6144), (4096, 4096),
                    (4, 4096), (4096, 1024), (4, 1024), (1792, 1024), (6000, 1024),
                    (4096, 896), (4, 896), (4096, 7168), (4, 7168)):
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

    timings = []
    # the rows timed beside SDPA, by the model whose decode shape they are
    models = {(48, 8): "dbrx (group 6)", (32, 8): "jamba (group 4)",
              (14, 2): "internvl2 (group 7)", (16, 16): "whisper (group 1)",
              (64, 8): "kimi-k2 (group 8, D 112)"}
    by_model = {name: [] for name in models.values()}
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, lens, Hq, Hkv, D in (
                (4, 512, [1, 97, 311, 512], 4, 2, 64),
                (8, 512, [1, 7, 64, 129, 256, 300, 511, 512], 4, 2, 64),
                (8, 4096, [1, 100, 1000, 2049, 3000, 4000, 4095, 4096], 4, 2, 64),
                # dbrx's, jamba's and internvl2's decode: the smoke's lanes
                # at 0, 1/5, 1/2 and the end of a 512 cache, one token in;
                # whisper's at max_len 448
                (4, 512, [1, 103, 257, 497], 48, 8, 128),
                (4, 512, [1, 103, 257, 497], 32, 8, 128),
                (4, 512, [1, 103, 257, 497], 14, 2, 64),
                (4, 448, [1, 90, 225, 433], 16, 16, 64),
                # kimi-k2's: 64 / 8 heads of head_dim 112 over a 4096 cache
                (4, 4096, [1, 1031, 2061, 4096], 64, 8, 112)):
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
            if B != 4 or (Hq == 4 and (dtype != torch.float32 or S != 512)):
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
                by_model[models[(Hq, Hkv)]].append(row)
    entries["decode_attention"]["shapes"] = [r for rows in by_model.values() for r in rows]
    emit({"phase": "model_kernels", "decode_attention": "ok", "times": timings, **by_model})
    return entries


#: the head_dim layout's decode (decode_scores, decode_combine) emulated
#: on one card: (tag, B, Hq, Hkv, S, D, ranks, dtype).  Each rank's slice
#: of head_dim is Dl = D / ranks columns: qwen3-1.7B at 2 and 16 "model"
#: ranks (Dl 64 and 8; the second is the dry run's 16x16 path and the
#: kernels line's row), dbrx-132b's group of 6, kimi-k2's Dl of 7,
#: internvl2-1b's Dl of 4 (group 7), the dry run's decode_32k slice of
#: qwen3-1.7B on 16x16 (128 sequences over 16 "data" ranks: B = 8 a rank,
#: S = 32768, Dl 8) and the wikikv-router (f32)
SPLIT_SHAPES = [("qwen3 tp=16", 4, 16, 8, 4096, 128, 16, "bfloat16"),
                ("qwen3 tp=2", 4, 16, 8, 4096, 128, 2, "bfloat16"),
                ("dbrx tp=16", 4, 48, 8, 4096, 128, 16, "bfloat16"),
                ("kimi-k2 tp=16", 4, 64, 8, 4096, 112, 16, "bfloat16"),
                ("internvl2 tp=16", 4, 14, 2, 4096, 64, 16, "bfloat16"),
                ("qwen3 decode_32k tp=16", 8, 16, 8, 32768, 128, 16, "bfloat16"),
                ("router tp=2", 4, 4, 2, 512, 64, 2, "float32")]


def split_bounds(B, Hq, Hkv, S, Dl, elt, live, peak) -> tuple[tuple, tuple]:
    """The bounds of one rank's decode_scores and decode_combine at a
    slice of Dl columns over ``live`` positions in all: scores reads q,
    the live K rows and the lengths and writes every score; combine reads
    the live scores and V rows and the lengths and writes the output; each
    does 2·Hq·live·Dl operations."""
    ops = 2.0 * Hq * live * Dl
    return (bound(B * Hq * Dl * elt + Hkv * live * Dl * elt + 4 * B * Hq * S + 4 * B, ops, peak),
            bound(4 * Hq * live + Hkv * live * Dl * elt + B * Hq * Dl * elt + 4 * B, ops, peak))


def split_decode_kernels(dev) -> dict:
    """decode_scores and decode_combine at SPLIT_SHAPES: every rank's
    slice's scores against the plain version, their sum (the all-reduce,
    here a sum on one card), every rank's combine against the plain
    version on that sum, and the slices' joined output against the fused
    decode_attention kernel and its plain version; the lanes at 1, a
    quarter, a half and the whole cache (twice over at B = 8).  One rank's calls timed beside
    the plain versions, one library call each (``torch.matmul`` of the q
    slice by the K slice; ``torch.softmax`` of the masked scores, then
    ``torch.matmul`` by the V slice), and the bytes bound of the live rows
    (K or V slice, the scores written or read); one kernel node a call.
    Returns the two kernels' JSON entries."""
    import torch
    from repro_torch.kernels import decode_split as dsp
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cpu").manual_seed(0)
    rows = {"decode_scores": [], "decode_combine": []}
    for tag, B, Hq, Hkv, S, D, ranks, dname in SPLIT_SHAPES:
        dtype = getattr(torch, dname)
        q = torch.randn((B, Hq, D), generator=g).to(dev, dtype)
        k = torch.randn((B, Hkv, S, D), generator=g).to(dev, dtype)
        v = torch.randn((B, Hkv, S, D), generator=g).to(dev, dtype)
        lens = ([1, S // 4 + 3, S // 2 + 1, S] * 2)[:B]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        Dl, scale = D // ranks, D ** -0.5
        cols = [slice(r * Dl, (r + 1) * Dl) for r in range(ranks)]
        qs = [q[..., c].contiguous() for c in cols]
        ks = [k[..., c].contiguous() for c in cols]
        vs = [v[..., c].contiguous() for c in cols]
        parts, err_s = [], 0.0
        for qr, kr in zip(qs, ks):
            parts.append(ops.decode_scores(qr, kr, ln, sm_scale=scale))
            err_s = max(err_s, check_float(f"decode_scores {tag}", parts[-1],
                                           ref.decode_scores_ref(qr, kr, ln, sm_scale=scale),
                                           torch.float32))
        sc = torch.stack(parts).sum(0)
        outs, err_c = [], 0.0
        for vr in vs:
            outs.append(ops.decode_combine(sc, vr, ln))
            err_c = max(err_c, check_float(f"decode_combine {tag}", outs[-1],
                                           ref.decode_combine_ref(sc, vr, ln), dtype))
        joined = torch.cat(outs, -1)
        err_f = check_float(f"split decode {tag} vs decode_attention", joined,
                            ops.decode_attention(q, k, v, ln), dtype)
        check_float(f"split decode {tag} vs the plain decode_attention", joined,
                    ref.decode_attention_ref(q, k, v, ln), dtype)
        # one rank's calls timed: the first slice
        qr, kr, vr = qs[0], ks[0], vs[0]
        live, elt, G = sum(lens), q.element_size(), Hq // Hkv
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        (b_s, by_s), (b_c, by_c) = split_bounds(B, Hq, Hkv, S, Dl, elt, live, peak)
        qg = (qr.reshape(B, Hkv, G, Dl) * scale).contiguous()
        kt = kr.transpose(-1, -2)
        valid = (torch.arange(S, device=dev)[None, :] < ln[:, None])[:, None, None, :]
        masked = torch.where(valid, sc.reshape(B, Hkv, G, S), float("-inf"))

        def lib_scores(qg, kt):
            return torch.matmul(qg, kt)

        def lib_combine(masked, vr):
            return torch.matmul(torch.softmax(masked, dim=-1).to(vr.dtype), vr)
        timed = {"decode_scores": (dsp.decode_scores, (qr, kr, ln), {"sm_scale": scale},
                                   lambda: ref.decode_scores_ref(qr, kr, ln, sm_scale=scale),
                                   lib_scores, (qg, kt), err_s, b_s, by_s),
                 "decode_combine": (dsp.decode_combine, (sc, vr, ln), {},
                                    lambda: ref.decode_combine_ref(sc, vr, ln),
                                    lib_combine, (masked, vr), err_c, b_c, by_c)}
        for name, (fn, args, kw, plain, lib, lib_args, err, b, by) in timed.items():
            gm = graph_ms(lambda *a: fn(*a, **kw), args)
            one_kernel_a_call(f"{name} {tag}", gm)
            rows[name].append({
                "shape": f"{tag}: q ({B}, {Hq}, {Dl}), cache ({B}, {Hkv}, {S}, {Dl}) of D={D}, "
                         f"lengths={lens} {dname}",
                "max_abs_err": err, "vs_fused_max_abs_err": err_f,
                "ms": cuda_ms(lambda: fn(*args, **kw)), "device_ms": gm["device_ms"],
                "host_ms": host_ms(lambda: fn(*args, **kw)), "plain_ms": cuda_ms(plain),
                "library_ms": cuda_ms(lambda: lib(*lib_args)),
                "library_device_ms": graph_ms(lib, lib_args)["device_ms"],
                "bound_ms": b, "bound_by": by,
                **({"combine_blocks": dsp.combine_plan(
                    B, Hkv, S, dsp.combine_span_min(G, Dl, elt),
                    torch.cuda.get_device_properties(0).multi_processor_count)}
                   if name == "decode_combine" else {})})
    entries = {}
    for name, rs in rows.items():
        entries[name] = {"name": name, "route": "cuda",
                         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                         "replaces": "src/repro/kernels/decode_attention.py:74",
                         **rs[0], "shapes": rs[1:]}
    emit({"phase": "split_decode_kernels", **{n: rs for n, rs in rows.items()},
          "nvidia_smi": nvidia_smi()})
    return entries


# (tag, B, Hq, Hkv, Sq, Skv, D, dtype, causal): (a) the ModelOracle's
# wikikv-router NLLs, (b) qwen3-1.7B prefill, (c) its chunked prefill,
# (d) whisper-medium's cross-attention shape (448 decoder x 1500 encoder
# positions, non-causal), (e) dbrx's group of 6 (48 / 8 heads), (f)
# jamba-v0.1-52b's prefill, its group of 4 (32 / 8 heads); the shapes of
# whisper-medium's path at B=4, all non-causal: (g) the encoder's
# self-attention over 1500 frames, (h) the decoder's cross-attention, (i)
# a decode step's cross-attention (one query over 1500 frames); (j)
# internvl2-1b's prefill (256 patch embeddings + 3840 tokens, 14 / 2
# heads); (k) more queries than keys, non-causal, in both types; (l)
# kimi-k2's prefill (64 / 8 heads of head_dim 112, padded to 128 columns
# in the bf16 body) and (m) a ragged f32 shape at head_dim 112
FLASH_SHAPES = [
    ("a S=7", 1, 4, 2, 7, 7, 64, "float32", True),
    ("a S=37", 1, 4, 2, 37, 37, 64, "float32", True),
    ("a S=113", 1, 4, 2, 113, 113, 64, "float32", True),
    ("b", 1, 16, 8, 4096, 4096, 128, "bfloat16", True),
    ("c", 1, 16, 8, 128, 4096, 128, "bfloat16", True),
    ("d", 1, 16, 16, 448, 1500, 64, "bfloat16", False),
    ("e", 1, 48, 8, 1024, 1024, 128, "bfloat16", True),
    ("f", 1, 32, 8, 4096, 4096, 128, "bfloat16", True),
    ("g", 4, 16, 16, 1500, 1500, 64, "bfloat16", False),
    ("h", 4, 16, 16, 448, 1500, 64, "bfloat16", False),
    ("i", 4, 16, 16, 1, 1500, 64, "bfloat16", False),
    ("j", 1, 14, 2, 4096, 4096, 64, "bfloat16", True),
    ("k f32", 1, 16, 16, 128, 64, 64, "float32", False),
    ("k", 1, 16, 16, 128, 64, 64, "bfloat16", False),
    ("l", 1, 64, 8, 4096, 4096, 112, "bfloat16", True),
    ("m f32", 1, 8, 1, 300, 1037, 112, "float32", True),
]


def attn_work(B, Hq, Hkv, Sq, Skv, D, causal, elt) -> tuple[float, float]:
    """(bytes, flops) of attention at these shapes: q, k and v read once,
    the output written once; 4·D flops per visible (query, key) pair."""
    off = Skv - Sq
    pairs = sum(min(i + off + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    return elt * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D), 4.0 * D * pairs * B * Hq


def exp_bound_ms(flops: float, D: int) -> float:
    """Least time of the exponentials of attention whose products are
    ``flops`` (4·D a visible pair, one exp2 each) on the special-function
    units: at head_dim 64 as long as the products on the tensor cores."""
    return flops / (4 * D) / EXP_PER_S * 1e3


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
        bf16 = dtype == torch.bfloat16
        tile = fa.query_tile(B, Hq, Sq, D=D) if bf16 else fa.BLOCK_Q
        row = {"shape": f"({tag}) B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} {dt} "
                        f"{'causal' if causal else 'non-causal'}",
               "block_q": tile,
               "exp_bound_ms": exp_bound_ms(flops, D) if D <= 64 else None,
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
def synthetic_store(scale_log2: int, store=None):
    """/dimDD/topic_DDTTT/entity_TTTKK: 16 dimensions x 256 topics x
    2^scale_log2 / 4096 entities — a depth-3 tree, every path <= 40
    bytes, built through put_record into ``store`` (one MemKV unless
    given) and compacted into a single sorted run at the end.  A durable
    store takes the load as the Table II durable backend does: one group
    commit of the whole load, then a major compaction."""
    from repro_torch.core import records as R
    from repro_torch.core.store import MemKV, PathStore
    n_files = (1 << scale_log2) // (N_DIMS * N_TOPICS)
    if store is None:
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
    if store.durable:
        store.flush()
    store.compact()
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


def queue_admits(planner, dims, rng, name: str, n: int, n_topics: int) -> list[str]:
    """Queue ``n`` file admits ``<name>_<i>`` under random topics among
    the first ``n_topics`` of each dimension; returns their paths."""
    from repro_torch.core import records as R
    out = []
    for i in range(n):
        d, t = rng.randrange(N_DIMS), rng.randrange(n_topics)
        path = f"/{dims[d]}/topic_{d:02d}{t:03d}/{name}_{i:03d}"
        planner.admit(path, R.FileRecord(name=f"{name}_{i:03d}", text=f"{name} {i}"))
        out.append(path)
    return out


def write_wave(dev_eng, dims, rng, phase="write_wave", name="online"):
    """64 admits through a BatchPlanner on the DeviceEngine and the
    refresh that must patch (on a durable store it also group-commits
    the wave with a DEVMARK); returns the new paths and the refresh ms."""
    from repro_torch.core.engine import BatchPlanner
    planner = BatchPlanner(dev_eng)
    new = queue_admits(planner, dims, rng, name, 64, 4)
    futs_done = planner.flush()
    t0 = time.perf_counter()
    epoch = dev_eng.refresh()
    ms = (time.perf_counter() - t0) * 1e3
    check(dev_eng.last_refresh_kind == "patch",
          f"write wave refresh took the {dev_eng.last_refresh_kind} path, not patch")
    emit({"phase": phase, "admits": len(new), "flushed": futs_done,
          "epoch": epoch, "refresh_kind": dev_eng.last_refresh_kind, "refresh_ms": ms})
    return new, ms


# ---------------------------------------------------------------------------
# phase 6: the durable tier — a crash in a child process, a reopen here
# ---------------------------------------------------------------------------
DURABLE_SHARDS = 4
DURABLE_MIN_FREE = 4 << 30     # bytes free the store needs (~0.7 GB at 2^20 files)
WAVE_A, WAVE_B = 64, 16        # admits committed before the crash, and flushed only


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root)
               for f in files)


def durable_child(dev, root: str, scale_log2: int) -> int:
    """The crash half of the durable phase, run in a process of its own:
    the synthetic wiki into a durable store at ``root`` (WAL fsync at
    every commit), a DeviceEngine on the card (which attaches the WAL's
    invalidation journal), a 64-admit write wave whose refresh patches
    and group-commits with a DEVMARK, wave A committed by a HostEngine
    sharing the device writer (the device never refreshes it), wave B
    flushed and never committed; one JSON line, then a process exit with
    no close."""
    import torch
    from repro_torch.core.engine import BatchPlanner, DeviceEngine, HostEngine
    from repro_torch.kernels import ops
    from repro_torch.storage import open_durable_store
    free = shutil.disk_usage(root).free
    check(free >= DURABLE_MIN_FREE, f"durable: {root} has {free} bytes free, the store "
          f"needs {DURABLE_MIN_FREE}; point TMPDIR at a larger disk")
    ops.reset_launches()
    t0 = time.perf_counter()
    store, dims, n_files = synthetic_store(
        scale_log2, open_durable_store(root, n_shards=DURABLE_SHARDS, sync="fsync"))
    build_s = time.perf_counter() - t0
    store_bytes = dir_bytes(root)
    t0 = time.perf_counter()
    eng = DeviceEngine.from_store(store, device=dev)
    from_store_s = time.perf_counter() - t0
    rng = random.Random(1)
    _, refresh_ms = write_wave(eng, dims, rng, phase="durable_write_wave")
    written_epoch = eng.epoch
    host = HostEngine(store, writer=eng.writer)
    planner = BatchPlanner(host)
    wave_a = queue_admits(planner, dims, rng, "wave_a", WAVE_A, N_TOPICS)
    planner.flush()
    committed = host.refresh()
    wave_b = queue_admits(planner, dims, rng, "wave_b", WAVE_B, N_TOPICS)
    planner.flush()
    check(all(store.get(p) is not None for p in wave_b), "durable: wave B was not applied")
    torch.cuda.synchronize()
    emit({"phase": "durable_child", "paths": eng.wiki.n, "shards": DURABLE_SHARDS,
          "sync": "fsync", "build_store_s": build_s, "store_bytes": store_bytes,
          "device_engine_s": from_store_s, "write_wave_epoch": written_epoch,
          "refresh_ms": refresh_ms, "committed_epoch": committed,
          "pending_before_crash": len(store.pending_invalidations()),
          "wave_a": wave_a, "wave_b": wave_b, "launches": dict(ops.LAUNCHES)})
    sys.stderr.flush()
    os._exit(0)                      # the crash: no close, no commit of wave B


def durable_crash_and_reopen(dev, scale_log2: int) -> tuple[dict, dict]:
    """Run ``durable_child`` in a child process, then reopen its store
    here and hold the reopened tier to what was committed; returns the
    child's launch counts and the phase's numbers."""
    from repro_torch.core.engine import DeviceEngine, HostEngine
    from repro_torch.runtime.serving import ServingEngine
    root = tempfile.mkdtemp(prefix="wikikv_durable_")
    try:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--durable-child",
                              root, str(scale_log2)], capture_output=True, text=True, timeout=900)
        child_s = time.perf_counter() - t0
        sys.stdout.write(run.stdout)
        sys.stdout.flush()
        if run.returncode != 0:
            sys.stderr.write(run.stderr[-8000:])
        check(run.returncode == 0, f"durable: the child exited with {run.returncode}")
        child = json.loads(run.stdout.strip().splitlines()[-1])
        check(child.get("phase") == "durable_child", "durable: the child printed no result")
        committed, wave_a, wave_b = child["committed_epoch"], child["wave_a"], child["wave_b"]
        check(child["write_wave_epoch"] + 1 == committed,
              f"durable: wave A committed epoch {committed}, the write wave "
              f"{child['write_wave_epoch']}")

        t0 = time.perf_counter()
        store = ServingEngine.reopen_store(root)
        reopen_s = time.perf_counter() - t0
        check(store.n_shards == DURABLE_SHARDS, f"durable: reopened {store.n_shards} shards")
        check(store.last_epoch() == committed,
              f"durable: reopened epoch {store.last_epoch()} != committed {committed}")
        pending = store.pending_invalidations()
        check(set(wave_a) <= set(pending), "durable: the journal lacks paths of wave A")
        check(not set(wave_b) & set(pending), "durable: the journal holds uncommitted wave B")
        t0 = time.perf_counter()
        eng = DeviceEngine.from_store(store, device=dev)
        from_store_s = time.perf_counter() - t0
        check(eng.epoch == committed, f"durable: rehydrated epoch {eng.epoch} != {committed}")
        check(sorted(eng.rehydrated_paths) == sorted(pending),
              "durable: rehydrated paths differ from the journal's pending set")
        check(store.pending_invalidations() == [], "durable: the journal is still pending")
        got = eng.q1_get(wave_a)
        check([r.text if r is not None else None for r in got]
              == [f"wave_a {i}" for i in range(WAVE_A)], "durable: Q1 lost a record of wave A")
        check(eng.q1_get(wave_b) == [None] * WAVE_B and
              all(store.get(p) is None for p in wave_b), "durable: wave B survived the crash")

        dims = [f"dim{d:02d}" for d in range(N_DIMS)]
        n_files = (1 << scale_log2) // (N_DIMS * N_TOPICS)
        rng = random.Random(2)
        batches = wave_batches(rng, dims, n_files, extra=wave_a)
        batches["q4"] = ("search", batches["q4"][1][:-8] + sorted(
            {p.rsplit("/", 1)[0] for p in wave_a})[:8])
        waves = drive_waves("durable_reopened", eng, HostEngine(store), batches)
        new, refresh_ms = write_wave(eng, dims, rng, phase="durable_write_wave_reopened",
                                     name="reopened")
        check(eng.epoch == committed + 1,
              f"durable: the write wave after the reopen made epoch {eng.epoch}")
        check(all(r is not None for r in eng.q1_get(new)), "durable: a reopened admit is lost")
        store.close()
        del eng, store
        t0 = time.perf_counter()
        again = ServingEngine.reopen_store(root)
        reopen2_s = time.perf_counter() - t0
        device_epochs = [s.engine.device_epoch() for s in again.shards]
        check(again.pending_invalidations() == [], "durable: the second reopen has pending paths")
        check(again.last_epoch() == committed + 1 and device_epochs == [committed + 1] * len(
            device_epochs), f"durable: second reopen epochs {again.last_epoch()} {device_epochs}")
        again.close()
        out = {"child_s": child_s, "build_store_s": child["build_store_s"],
               "store_bytes": child["store_bytes"], "child_device_engine_s":
               child["device_engine_s"], "child_refresh_ms": child["refresh_ms"],
               "reopen_s": reopen_s, "device_engine_s": from_store_s,
               "rehydrated_paths": len(pending), "committed_epoch": committed,
               "reopened_refresh_ms": refresh_ms, "second_reopen_s": reopen2_s,
               "waves": waves}
        return child["launches"], out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serve_restart(device, root=None, n_docs=160, seed=0, n_requests=8) -> dict:
    """serve_once's wiki and requests, served in two halves: the first
    half with 8 online admits queued, ``snapshot()``, then the second.
    With ``root`` the wiki is built into ``open_durable_store(root,
    n_shards=2)``, and between the halves the store is closed, reopened
    by ``ServingEngine.reopen_store`` and served by a new ServingEngine
    over ``DeviceEngine.from_store`` of it; without, one ServingEngine
    over a MemKV store serves both halves.  Returns the requests, the
    decode log, the serve calls and the epochs and path counts."""
    import torch
    from repro_torch.core import records as R
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.oracle import HeuristicOracle
    from repro_torch.runtime.serving import Request, ServingEngine
    from repro_torch.storage import open_durable_store

    store = open_durable_store(root, n_shards=2, sync="fsync") if root else None
    pipe, docs, questions = authtrace_wiki(n_docs, seed, store)
    cfg, tok, params = router_lm(device, docs, seed)
    log, calls = [], []

    def serving(st):
        eng = ServingEngine(cfg, params, tok, DeviceEngine.from_store(st, device=device),
                            HeuristicOracle(), batch_size=4, max_len=512, device=device)
        calls.append(log_decode(eng, cfg, log))
        return eng

    reqs = [Request(rid=q.qid, query=q.text, max_new_tokens=16) for q in questions[:n_requests]]
    half = n_requests // 2
    eng = serving(pipe.store)
    admits = [f"/entities/durable_{i}" for i in range(8)]
    for i, p in enumerate(admits):
        eng.submit_admit(p, R.FileRecord(name=f"durable_{i}", text=f"durable admit {i}"))
    t0 = time.perf_counter()
    done = eng.run(reqs[:half])
    snap = eng.snapshot()
    out = {"snapshot": snap, "reopen_s": None}
    if root is not None:
        pipe.store.close()
        del eng
        t1 = time.perf_counter()
        reopened = ServingEngine.reopen_store(root)
        out["reopen_s"] = time.perf_counter() - t1
        eng = serving(reopened)
        out.update(reopened_epoch=eng.engine.epoch, reopened_paths=reopened.count())
    done += eng.run(reqs[half:])
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    check(len(done) == n_requests, f"served {len(done)} of {n_requests} requests")
    check(all(r is not None for r in eng.engine.q1_get(admits)), "an online admit is lost")
    if root is not None:
        eng.engine.store.close()
    out.update(done=done, log=log, calls=sum(c["n"] for c in calls))
    return out


def decoded(log) -> list:
    """The decoding lanes and their next tokens at every step of a
    ``log_decode`` log (an idle lane's output is not a token)."""
    return [[(i, t) for i, (t, on) in enumerate(zip(g[0], g[3])) if on] for g in log]


def durable_serving(dev) -> tuple[dict, dict]:
    """The serving restart over a durable store on the card, against the
    same run on the CPU and an uninterrupted run over MemKV on the card;
    returns the card run's launch counts and the phase's numbers."""
    import torch
    from repro_torch.kernels import ops
    roots = [tempfile.mkdtemp(prefix="wikikv_serving_") for _ in range(2)]
    try:
        ops.reset_launches()
        card = serve_restart(dev, roots[0])
        counts = dict(ops.LAUNCHES)
        mem = serve_restart(dev)
        cpu = serve_restart(torch.device("cpu"), roots[1])
    finally:
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    snap = card["snapshot"]
    check(card["reopened_epoch"] == snap["epoch"] and card["reopened_paths"] == snap["paths"],
          f"durable serving: reopened at epoch {card['reopened_epoch']} with "
          f"{card['reopened_paths']} paths, snapshot {snap}")
    check(snap == cpu["snapshot"] == mem["snapshot"], "durable serving: snapshots differ")
    traces = [nav_trace(r) for r in card["done"]]
    check(traces == [nav_trace(r) for r in mem["done"]],
          "durable serving: traces differ from the uninterrupted MemKV run")
    check(decoded(card["log"]) == decoded(mem["log"]) and
          [r.answer for r in card["done"]] == [r.answer for r in mem["done"]],
          "durable serving: tokens differ from the uninterrupted MemKV run")
    check(traces == [nav_trace(r) for r in cpu["done"]],
          "durable serving: traces differ between the card and the CPU")
    near_tie, compared = decode_parity(card["log"], cpu["log"])
    if near_tie is None:
        check(len(card["log"]) == len(cpu["log"]) and
              [r.answer for r in card["done"]] == [r.answer for r in cpu["done"]],
              "durable serving: tokens differ between the card and the CPU")
    emit({"phase": "durable_serving", "requests": len(card["done"]),
          "serve_steps": card["calls"], "snapshot": snap, "reopen_s": card["reopen_s"],
          "wall_s": {"card_durable": card["wall_s"], "card_memkv": mem["wall_s"],
                     "cpu_durable": cpu["wall_s"]},
          "tokens_equal_memkv": True, "tokens_equal_cpu": near_tie is None,
          "near_tie": near_tie, "decode_steps_compared": compared, "launches": counts})
    return counts, {"serve_steps": card["calls"], "wall_s": card["wall_s"]}


def durable_phase(dev, scale_log2: int, query_refresh_ms: float) -> dict:
    """The durable path: the crash and reopen of the synthetic wiki, then
    the serving restart.  Counts are set to 0 before each part that runs
    here and summed with the child's; returns them.  ``query_refresh_ms``
    (the query phase's patch refresh over MemKV) is printed beside the
    durable ones."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    child_counts, crash = durable_crash_and_reopen(dev, scale_log2)
    reopen_counts = dict(ops.LAUNCHES)
    serve_counts, serving = durable_serving(dev)
    counts = {k: child_counts.get(k, 0) + reopen_counts[k] + serve_counts[k]
              for k in reopen_counts}
    emit({"phase": "durable", "files_log2": scale_log2,
          "cut": f"2^{scale_log2} files of the query phase's 2^{SCALE_LOG2}, cut for time",
          **crash, "query_phase_refresh_ms": query_refresh_ms,
          "serving": serving, "launches": counts})
    for name in ("path_lookup", "prefix_search", "rmsnorm", "decode_attention"):
        check(counts[name] > 0, f"the durable phase ran no {name}")
    return counts


# ---------------------------------------------------------------------------
# phases 7 and 9: serving at full width, with the heuristic or the LM oracle
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


def authtrace_wiki(n_docs: int, seed: int, store=None):
    """The AuthTrace wiki the serving runs navigate, built by the
    construction pipeline into ``store`` (a MemKV PathStore unless
    given); returns the pipeline, the documents and the questions."""
    from repro_torch.core.oracle import HeuristicOracle
    from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig
    from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace
    docs, questions = generate_authtrace(
        AuthTraceConfig(n_docs=n_docs, n_questions=100, seed=seed))
    pipe = ConstructionPipeline(PipelineConfig(), HeuristicOracle(), store=store)
    pipe.writer.clock = lambda: 0.0          # every run builds the same bytes
    pipe.bootstrap(docs)
    for i in range(0, len(docs), 16):
        pipe.ingest(docs[i:i + 16])
    return pipe, docs, questions


def router_lm(device, docs, seed: int):
    """wikikv-router at full width with random weights from ``seed`` on
    ``device``, and the tokenizer fitted on ``docs``."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import model as M
    cfg = get_config("wikikv-router")
    tok = HashTokenizer(vocab_size=cfg.vocab).fit([d["text"] for d in docs])
    return cfg, tok, M.init_params(cfg, seed=seed, device=device)


def log_decode(eng, cfg, log: list) -> dict:
    """Wrap ``eng``'s serve step: count its calls and append one entry a
    decode step (not a prefill step) to ``log``: the next tokens, the
    top-2 logit gap and |top-1| of every lane, the decoding lanes."""
    import torch
    calls = {"n": 0, "prefill": False}
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
    return calls


def serve_once(device, model_oracle=False, n_docs=160, seed=0, n_requests=8) -> dict:
    """Serve AuthTrace questions with wikikv-router over a DeviceEngine on
    ``device``; the navigation oracle is the heuristic one, or with
    ``model_oracle`` a ModelOracle over the same LM.  Returns the requests,
    their evidence answers, the per-decode-step log, the serve calls, the
    wall time and the oracle's log."""
    import torch
    from repro_torch.core import records as R
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.oracle import HeuristicOracle
    from repro_torch.runtime.model_oracle import ModelOracle
    from repro_torch.runtime.serving import Request, ServingEngine

    pipe, docs, questions = authtrace_wiki(n_docs, seed)
    cfg, tok, params = router_lm(device, docs, seed)
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
    log = []
    calls = log_decode(eng, cfg, log)
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


def nav_trace(r):
    """A served request's navigation: route, calls, pages and results."""
    return (r.rid, r.trace.route, r.trace.llm_calls, r.trace.tool_calls, r.trace.pages_read,
            [(x.kind, x.path, x.text) for x in r.nav_results])


def decode_parity(gpu_log, cpu_log) -> tuple[dict | None, int]:
    """Greedy tokens of two decode logs (``log_decode``): equal at every
    step, unless the CPU run's top-2 logit gap at the first differing step
    is below the f32 tolerance.  Returns (that near tie or None, the steps
    compared before it)."""
    for step, (g, c) in enumerate(zip(gpu_log, cpu_log)):
        lanes = [i for i, on in enumerate(c[3]) if on]
        diff = [i for i in lanes if g[0][i] != c[0][i]]
        if diff:
            i = diff[0]
            gap, tol = c[1][i], F32_TOL["atol"] + F32_TOL["rtol"] * c[2][i]
            check(gap < tol, f"decode step {step} lane {i}: tokens differ "
                  f"(card {g[0][i]}, cpu {c[0][i]}) with a top-2 gap {gap} >= {tol}")
            return {"step": step, "lane": i, "gap": gap, "tol": tol}, step
    return None, min(len(gpu_log), len(cpu_log))


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

    check([nav_trace(r) for r in gpu["done"]] == [nav_trace(r) for r in cpu["done"]],
          "navigation traces differ between the card and the CPU")
    check(gpu["evidence"] == cpu["evidence"],
          "evidence answers differ between the card and the CPU")
    gpu_log, cpu_log = gpu["log"], cpu["log"]
    near_tie, compared = decode_parity(gpu_log, cpu_log)
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
# phase 10: qwen3-1.7B prefill / eval at full width
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
# phase 11: the MoE path — moe_router, then dbrx-132b at full width
# ---------------------------------------------------------------------------
# (tag, T, E, k): dbrx prefill (S=4096) and decode (B=4), jamba, kimi-k2,
# a ragged T, and jamba's train step cut to 2 experts (k = E)
ROUTER_SHAPES = [("dbrx prefill", 4096, 16, 4), ("dbrx decode", 4, 16, 4),
                 ("jamba", 4096, 16, 2), ("jamba decode", 4, 16, 2), ("kimi-k2", 4096, 384, 8),
                 ("ragged", 4099, 16, 4), ("jamba train cut", 4096, 2, 2)]
ROUTER_NEAR_TIE = 1e-6   # two candidates' probabilities this close may order either way


def router_library(logits, k, renormalize=True):
    """softmax -> topk -> renorm, three PyTorch calls (the yardstick only)."""
    import torch
    w, idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    return (w / w.sum(dim=-1, keepdim=True) if renormalize else w), idx


def router_kernels(dev, floor_ms: float) -> dict:
    """(a) moe_router against its plain version at ROUTER_SHAPES, with
    renormalize on and off, on random-normal and on tie-laden logits (a
    grid of 0.5).  Indices equal in every tie-laden row; on normal input a
    row may differ only where two of its k + 1 largest probabilities lie
    within ROUTER_NEAR_TIE (counted); weights within 1e-6 on the rows that
    agree.  Timed beside its bytes bound, the plain version and the
    library composite.  (b) moe_router_bwd's rows (``router_bwd_rows``),
    each beside the kernel node floor ``floor_ms``."""
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
                # the gaps between the k + 1 largest (the k largest when k = E)
                near = (p[:, :-1] - p[:, 1:])[:, :k].amin(dim=-1) < ROUTER_NEAR_TIE
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
    bwd_rows = router_bwd_rows(dev, g, floor_ms)
    return {"moe_router": {"name": "moe_router", "route": "cuda",
                           "source": "src/repro_torch/kernels/csrc/moe_router.cu",
                           "replaces": "src/repro/kernels/moe_router.py:55",
                           **rows[0], "shapes": rows[1:]},
            "moe_router_bwd": {"name": "moe_router_bwd", "route": "cuda",
                               "source": "src/repro_torch/kernels/csrc/moe_router.cu",
                               "replaces": "src/repro/kernels/moe_router.py:55",
                               "note": "the Pallas kernel has no backward: jax.value_and_grad "
                                       "of its jnp reference",
                               **bwd_rows[0], "shapes": bwd_rows[1:]}}


# (tag, T, E, k): the training shapes of the MoE families at S = 4096,
# jamba's train step cut to 2 experts and kimi-k2's to 32 among them
ROUTER_BWD_SHAPES = [("dbrx prefill", 4096, 16, 4), ("jamba", 4096, 16, 2),
                     ("kimi-k2", 4096, 384, 8), ("ragged", 4099, 16, 4),
                     ("jamba train cut", 4096, 2, 2), ("kimi-k2 train cut", 4096, 32, 8)]


def router_bwd_rows(dev, g, floor_ms: float) -> list:
    """(b) moe_router_bwd against its plain version (``ref.moe_router_bwd_ref``)
    at ROUTER_BWD_SHAPES, renormalized and not, on normal and tie-laden
    logits (the forward kernel's weights and ids), within the f32 backward
    tolerance; timed beside its bytes bound, the plain version and the
    autograd backward of the softmax -> topk -> renorm composite, one
    kernel node a call, with its launch geometry (``router_bwd_geometry``)
    and its time over the node floor ``floor_ms``.  The first row (dbrx,
    renormalized, normal logits) leads the kernels line."""
    import torch
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    rows = []
    for tag, T, E, k in ROUTER_BWD_SHAPES:
        x = torch.randn((T, E), generator=g).to(dev) * 2
        dw = torch.randn((T, k), generator=g).to(dev)
        for renorm in (True, False):
            err = 0.0
            for logits in (x, torch.round(x * 2) / 2):
                w, idx = mr.moe_router(logits, k, renormalize=renorm)
                lg = None if renorm else logits
                got = mr.moe_router_bwd(lg, w, idx, dw, renormalize=renorm, n_experts=E)
                want = ref.moe_router_bwd_ref(logits, w, idx, dw, renormalize=renorm)
                err = max(err, check_grad(f"moe_router_bwd ({tag})", got, want, torch.float32))
                check(torch.equal(mr.moe_router_bwd(lg, w, idx, dw, renormalize=renorm,
                                                    n_experts=E), got),
                      f"moe_router_bwd ({tag}) is not bit for bit repeatable")
            w, idx = mr.moe_router(x, k, renormalize=renorm)
            lg = None if renorm else x

            def kernel(a, b, c, d, renorm=renorm, E=E):
                return mr.moe_router_bwd(a, b, c, d, renormalize=renorm, n_experts=E)
            # bytes: the weights, ids and gradients read, the (T, E) gradient
            # written (and the logits read without renormalize); operations:
            # a product and a sum per chosen expert, and without renormalize
            # two exponentials, a divide and a product per logit
            nbytes = T * k * 12 + T * E * 4 + (0 if renorm else T * E * 4)
            b, by = bound(nbytes, T * k * 4.0 + (0 if renorm else T * E * 8.0), F32_FLOPS)
            gm = graph_ms(kernel, (lg, w, idx, dw))
            one_kernel_a_call(f"moe_router_bwd ({tag})", gm)
            lib = library_grad(lambda z, k=k, r=renorm: router_library(z, k, r)[0], (x,), dw)
            lib_ms = cuda_ms(lib)
            rows.append({"shape": f"({tag}) T={T} E={E} k={k} float32 "
                                  f"{'renormalized' if renorm else 'not renormalized'}",
                         "geometry": dict(zip(("lanes_a_token", "pieces_a_lane", "warps_a_block",
                                               "blocks"), mr.router_bwd_geometry(T, E, k))),
                         "max_abs_err": err, "ms": cuda_ms(lambda: kernel(lg, w, idx, dw)),
                         "device_ms": gm["device_ms"],
                         "over_node_floor": gm["device_ms"] / floor_ms,
                         "device_ms_profiled": profiled_ms(kernel, (lg, w, idx, dw), 10),
                         "host_ms": host_ms(lambda: kernel(lg, w, idx, dw)),
                         "plain_ms": cuda_ms(lambda: ref.moe_router_bwd_ref(
                             x, w, idx, dw, renormalize=renorm)),
                         "library_ms": lib_ms, "library_device_ms": profiled_ms(lib, (), 10),
                         "bound_ms": b, "bound_by": by, "gb_per_s": nbytes / gm["device_ms"] / 1e6,
                         "device_share_of_bound": b / gm["device_ms"]})
    emit({"phase": "moe_router_bwd", "tolerance_f32": BWD_F32_TOL, "shapes": rows,
          "library": "autograd backward of softmax -> topk -> renorm"})
    return rows


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


def moe_phase(dev, arch="dbrx-132b", tag="moe", seed=0, layers=8, seq=4096, dec_batch=4,
              dec_len=512, dec_steps=16, parity_seq=128, tf_tokens=16, parity_cfg=None) -> dict:
    """(b) an MoE model at full width (dbrx-132b cut to ``layers`` of 40
    to fit one card; kimi-k2 to its dense prefix layer and one MoE layer
    of 384 experts), weights drawn on the card from ``seed``: one prefill
    and one eval at B=1, S=``seq``, then ``dec_steps`` serve steps at
    B=``dec_batch``, max_len ``dec_len`` — the launches counted — then
    their times beside their bounds.  (c) parity, in the ``{tag}_parity``
    line: the first 2 layers (1 when the host is short of memory), or a
    model of ``parity_cfg`` drawn on the card where one is given, upcast
    to f32 on the card and on the CPU at S=``parity_seq``: router indices
    equal but at near ties, logits within 1e-3 of the largest; the bf16
    run's share of assignments whose expert differs from the f32 run; and
    teacher-forced decode of ``tf_tokens`` tokens against the prefill
    logits at capacity_factor 64."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    m = cfg.moe
    n_moe = layers - cfg.n_dense_prefix            # every body layer is an MoE layer
    torch.cuda.empty_cache()
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
    check(bool(torch.isfinite(logits).all()), f"non-finite {arch} prefill logits")
    check(math.isfinite(loss) and loss > 0, f"{arch} eval loss {loss}")
    del logits
    fwd = dict(ops.LAUNCHES)
    for _ in range(dec_steps):
        tk, dec_logits, state = serve(params, state, {"tokens": tk, "lengths": lens})
        lens = lens + 1
    check(bool(torch.isfinite(dec_logits[:, :cfg.vocab]).all()), "non-finite decode logits")
    counts = dict(ops.LAUNCHES)
    dec = {k: counts[k] - fwd[k] for k in counts}
    n_norm = 2 * layers + 1
    for name, per_fwd, per_step in (("moe_router", n_moe, n_moe),
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
    check(len(log_pre) == len(log_dec) == n_moe, "router calls per forward / step != MoE layers")
    # attention of every layer, the dense prefix's MLP, each MoE layer's
    # router and shared expert (kimi), the head
    expert_flops = 3 * 2 * D * F_               # one (token, expert) assignment
    dense = (layers * (2 * seq * D * (2 * H * Dh + 2 * KV * Dh) + 4.0 * Dh * H * seq * (seq + 1) / 2)
             + cfg.n_dense_prefix * 3 * 2 * seq * D * cfg.d_ff
             + n_moe * (2 * seq * D * E + expert_flops * seq * m.n_shared) + 2 * seq * D * V)
    flops = dense + expert_flops * kept
    flops_dispatch = dense + expert_flops * n_moe * E * cap
    b_pre, by_pre = bound(w_bytes, flops, BF16_FLOPS)
    b_pre_d, by_pre_d = bound(w_bytes, flops_dispatch, BF16_FLOPS)
    expert_bytes = 3 * D * F_ * torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    emb_bytes = params["embed"].numel() * params["embed"].element_size()
    kv_bytes = 2 * layers * KV * Dh * 2 * sum(n + dec_steps for n in lens0)
    rest_bytes = w_bytes - emb_bytes - n_moe * E * expert_bytes + kv_bytes
    b_dec, by_dec = bound(rest_bytes + expert_bytes * sum(routed),
                          expert_flops * n_moe * dec_batch * m.top_k, BF16_FLOPS)
    b_dec_d, by_dec_d = bound(rest_bytes + expert_bytes * n_moe * E,
                              expert_flops * n_moe * E * cap_dec, BF16_FLOPS)
    emit({"phase": tag, "arch": cfg.name, "layers": layers, "of": full.n_layers,
          "moe_layers": n_moe, "experts": E, "top_k": m.top_k, "head_dim": Dh,
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
          "decode_dispatch_gb": (rest_bytes + expert_bytes * n_moe * E) / 1e9,
          "decode_dispatch_bound_ms": b_dec_d, "decode_dispatch_bound_by": by_dec_d,
          "prefill_breakdown_ms": {"moe_ffn_per_layer": moe_ms, "flash_per_layer": flash_ms,
                                   "moe_ffn": n_moe * moe_ms, "flash": layers * flash_ms,
                                   "rest": prefill_ms - n_moe * moe_ms - layers * flash_ms},
          "decode_breakdown_ms": {"moe_ffn_per_layer": moe_dec_ms, "moe_ffn": n_moe * moe_dec_ms,
                                  "rest": decode_ms - n_moe * moe_dec_ms},
          "nvidia_smi": nvidia_smi()})

    if parity_cfg is not None:
        # (c) parity on a smaller model of the same family, drawn on the card
        del params, state, dec_logits, step
        torch.cuda.empty_cache()
        small = T.init_params(torch.Generator(device=dev).manual_seed(seed + 1), parity_cfg)
        p_toks = np.random.RandomState(seed + 1).randint(
            0, parity_cfg.vocab, size=(1, parity_seq)).astype(np.int32)
        out = moe_parity(dev, parity_cfg, small, p_toks, parity_seq, tf_tokens)
        emit({"phase": f"{tag}_parity", "arch": parity_cfg.name, "layers": parity_cfg.n_layers,
              "d_model": parity_cfg.d_model, "head_dim": parity_cfg.head_dim,
              "experts": parity_cfg.moe.n_experts, "top_k": parity_cfg.moe.top_k, **out})
        return counts
    # (c) parity on the first layers, the rest of the card's weights freed
    f32_bytes = 2 * (w_bytes / layers * 2 + 2 * emb_bytes)
    n_par = 2 if host_mem_available() >= 1.5 * f32_bytes else 1
    small = {**params, "body": tree_map(lambda t: t[:n_par].clone(), params["body"])}
    del params, state, dec_logits, step
    torch.cuda.empty_cache()
    out = moe_parity(dev, dataclasses.replace(cfg, n_layers=n_par), small, toks, parity_seq,
                     tf_tokens)
    emit({"phase": f"{tag}_parity", "layers": n_par,
          "layers_note": None if n_par == 2 else "1 layer: the host is short of memory", **out})
    return counts


def kimi_small(experts: int, dtype: str):
    """A reduced kimi-k2 at its own head_dim of 112 (8 query heads over
    one KV head: its group of 8), its dense prefix layer and one MoE
    layer of ``experts`` experts (top 8) and the shared expert: the
    parities' model."""
    import dataclasses

    from repro_torch.configs import get_config
    full = get_config("kimi-k2-1t-a32b")
    return full.reduced(n_layers=2, d_model=256, n_heads=8, n_kv_heads=1, d_head=112,
                        vocab=4096, dtype=dtype, param_dtype=dtype,
                        moe=dataclasses.replace(full.moe, n_experts=experts, d_ff_expert=128))


def kimi_phase(dev) -> dict:
    """kimi-k2-1t-a32b served at full width, cut to 2 of its 61 layers:
    the dense prefix layer and one MoE layer with all 384 experts (top 8)
    and the shared expert, bf16, ~19.8 B parameters (~39.5 GB: the experts
    33.8 GB, the untied embedding and head 4.7 GB, the dense layer
    ~0.9 GB; a third layer would need ~73 GB of weights).  Prefill and
    eval at B=1, S=4096, 16 decode steps at B=4 (``moe_phase``, its
    launches checked exactly); then ``kimi_parity``: a reduced kimi at
    head_dim 112 with 384 experts, f32 on the card against the CPU."""
    return moe_phase(dev, arch="kimi-k2-1t-a32b", tag="kimi", layers=2, parity_seq=128,
                     tf_tokens=16, parity_cfg=kimi_small(384, "bfloat16"))


def moe_parity(dev, cfg_p, small: dict, toks, parity_seq: int, tf_tokens: int) -> dict:
    """f32 parity of an MoE model's first layers with the CPU.  ``small``
    (the card's weights of ``cfg_p``; emptied as they are upcast) runs once
    in ``cfg_p``'s dtype with its router logged, then upcast to f32 on the
    card and on the CPU at S=``parity_seq``: router indices equal but at
    near ties, logits within 1e-3 of the largest; the bf16 run's share of
    assignments whose expert differs from the f32 run; and teacher-forced
    decode of ``tf_tokens`` tokens against the prefill logits at
    capacity_factor 64.  Returns the numbers of the parity line."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    m = cfg_p.moe
    cfg32 = dataclasses.replace(cfg_p, dtype="float32", param_dtype="float32")
    cfg64 = dataclasses.replace(cfg32, moe=dataclasses.replace(m, capacity_factor=64.0))
    fwd32 = M.make_prefill_step(cfg32)
    tokens = torch.from_numpy(toks[:, :parity_seq])
    _, log_bf = logged_run(lambda: M.make_prefill_step(cfg_p)(small, {"tokens": tokens.to(dev)}))
    card32_p = tree_map(lambda t: t.float(), small)
    small.clear()
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
    check(err <= 1e-3 * scale,
          f"{cfg_p.name} f32 logits card vs cpu differ by {err} > 1e-3 x {scale}")
    changed = total = 0
    for (_, i32), (_, ibf) in zip(log_card, log_bf):
        for a, b in zip(i32.tolist(), ibf.tolist()):
            changed += len(set(b) - set(a))
            total += len(a)
    # decode: one router call per MoE layer per step (T=1); regroup as the
    # prefill's (layer, token) rows
    n_r = len(log_tf_full)
    dec_log = [(torch.cat([log_tf_dec[t * n_r + layer][0] for t in range(tf_tokens)]),
                torch.cat([log_tf_dec[t * n_r + layer][1] for t in range(tf_tokens)]))
               for layer in range(n_r)]
    tf_flip = first_flip(log_tf_full, dec_log, k)
    tf_upto = tf_tokens if tf_flip is None else tf_flip["token"]
    tf_scale = float(tf_full.abs().max())
    tf_err = float((got[0, :tf_upto] - tf_full[0, :tf_upto]).abs().max()) if tf_upto else 0.0
    check(tf_err <= 1e-3 * tf_scale, f"{cfg_p.name} teacher-forced decode vs prefill differ "
          f"by {tf_err} > 1e-3 x {tf_scale}")
    return {"seq": parity_seq, "dtype": "float32 (bf16 weights upcast)", "cpu_forward_s": cpu_s,
            "max_abs_card_cpu": err, "max_abs_logit": scale, "tolerance": 1e-3 * scale,
            "router_near_tie": flip, "tokens_compared": upto,
            "bf16_assignments_changed": changed, "bf16_assignments": total,
            "bf16_share_changed": changed / max(total, 1),
            "teacher_forced": {"tokens": tf_tokens, "capacity_factor": 64.0,
                               "max_abs_decode_prefill": tf_err, "max_abs_logit": tf_scale,
                               "router_near_tie": tf_flip, "tokens_compared": tf_upto}}


# ---------------------------------------------------------------------------
# phase 12: the SSM and xLSTM families — jamba-v0.1-52b and xlstm-350m
# ---------------------------------------------------------------------------
# launches of each kernel (per forward, per decode step) on the two paths:
# jamba cut to one period of 8 layers (1 attention, 4 MoE, 8 x 2 block
# norms + the final one), xlstm to one period, 8 of its 24 (one norm a
# block: the xLSTM blocks carry their own FFN); both were cut to keep the
# smoke inside its time limit on a slower host
RECURRENT_LAUNCHES = {
    "jamba-v0.1-52b": {"rmsnorm": (17, 17), "flash_attention": (1, 0),
                       "decode_attention": (0, 1), "moe_router": (4, 4)},
    "xlstm-350m": {"rmsnorm": (9, 9), "flash_attention": (0, 0),
                   "decode_attention": (0, 0), "moe_router": (0, 0)},
}


def path_launches(cfg) -> dict:
    """(per forward, per decode step) launches of each model kernel,
    counted from the config's layers (two block norms an attention or
    mamba layer, one an xLSTM block, two more for a qk-norm, the final
    norm once; a dense prefix layer is an attention layer)."""
    from repro_torch.models import transformer as T
    kinds = ["attn"] * cfg.n_dense_prefix + list(cfg.block_pattern) * cfg.n_periods
    n_attn = kinds.count("attn")
    n_moe = cfg.n_periods * sum(T._slot_is_moe(cfg, s) for s in range(len(cfg.block_pattern)))
    n_norm = sum(2 if k in ("attn", "mamba") else 1 for k in kinds) + 2 * cfg.qk_norm * n_attn + 1
    return {"rmsnorm": (n_norm, n_norm), "flash_attention": (n_attn, 0),
            "decode_attention": (0, n_attn), "moe_router": (n_moe, n_moe)}


def interleaved_ms(fns: dict, rounds: int = 3) -> dict:
    """Median ms of each callable by CUDA events, the callables taking
    turns (one warm-up call each first), so each samples the same host
    conditions."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, iters=1, warmup=0))
    return {k: statistics.median(v) for k, v in times.items()}


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def mixed_bound(bytes_moved: float, bf16_ops: float, f32_ops: float) -> tuple[float, str]:
    """``bound`` for work of two types: bf16 products on the tensor cores
    and float32 operations outside them, each at its own peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def recurrent_prefill_ops(cfg, seq: int, kept: int) -> tuple[float, float]:
    """(bf16, float32) operations of one forward at B=1, S=``seq``: the
    projections, causal attention, the dense FFNs, the router and the
    ``kept`` (token, expert) assignments, the head (bf16); the mamba scan
    (8 per state element a step: exp(Δ A), Δ B x, the step, the readout),
    the mLSTM chunks' products (f32, TF32 off) and the sLSTM cell (f32)."""
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as X
    S, D, V = seq, cfg.d_model, cfg.padded_vocab
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Din, N, K = cfg.ssm_expand * D, cfg.d_state, cfg.d_conv
    Hx, Dp = cfg.xlstm_heads, 2 * D
    Dhx, c, f = Dp // Hx, min(256, S), X.slstm_ffn_width(D)
    bf16 = 2.0 * S * D * V
    f32 = 0.0
    for _ in range(cfg.n_periods):
        for s, kind in enumerate(cfg.block_pattern):
            if kind == "attn":
                bf16 += 2.0 * S * D * (2 * H * Dh + 2 * KV * Dh) + 4.0 * Dh * H * S * (S + 1) / 2
            elif kind == "mamba":
                bf16 += 2.0 * S * (D * 2 * Din + Din * 2 * N + Din * Din + Din * D + Din * K)
                f32 += 8.0 * S * Din * N
            elif kind == "mlstm":
                bf16 += 2.0 * S * (D * 2 * Dp + 3 * Dp * Dp + Dp * 2 * Hx + Dp * D)
                f32 += S * Hx * (4.0 * c * Dhx + 4.0 * Dhx * Dhx)
            else:
                bf16 += 2.0 * S * (D * 4 * D + D * 4 * (D // Hx) + D * 2 * f + f * D)
                f32 += 20.0 * S * D
            if kind in ("attn", "mamba"):
                if T._slot_is_moe(cfg, s):
                    bf16 += 2.0 * S * D * cfg.moe.n_experts
                else:
                    bf16 += 6.0 * S * D * cfg.d_ff
    if cfg.moe is not None:
        bf16 += 6.0 * D * cfg.moe.d_ff_expert * kept
    return bf16, f32


def recurrent_state_bytes(cfg, batch: int) -> int:
    """Bytes of the recurrent states one decode step reads and writes
    (float32), the KV caches left out."""
    D = cfg.d_model
    Din, Hx = cfg.ssm_expand * D, cfg.xlstm_heads
    Dhx = 2 * D // Hx
    per = {"attn": 0, "mamba": batch * ((cfg.d_conv - 1) * Din + Din * cfg.d_state),
           "mlstm": batch * Hx * (Dhx * Dhx + Dhx + 1), "slstm": 4 * batch * D}
    return 2 * 4 * cfg.n_periods * sum(per[k] for k in cfg.block_pattern)


XLSTM_PREFIX_MAX = 6      # the deepest prefix of layers held end to end
WITNESS_SHARE = 2.5e-4    # a prefix is held while the card's own witness stays within this share
XLSTM_PREFIX_MIN = 3      # of the largest logit (a quarter of the tolerance), at least this deep


def blockwise_parity(dev, cfg, card_p, host_p, tokens, tf_tokens, card_logits,
                     cpu_logits) -> dict:
    """f32 parity of a model whose layers amplify rounding (xlstm-350m
    with random weights: a perturbation of 1e-7 in the embeddings grows
    to the logits' own size by the last layer, so no two implementations
    that round differently agree at full depth).  Three checks:

    * each layer alone, on the CPU chain's input to it: the card's
      prefill of the layer against the CPU's, within 1e-3 of the layer's
      largest output (at S=512 the mLSTM runs two chunks of 256, so the
      (C, n, m) carry between chunks is compared); on the first
      ``tf_tokens`` of that input, the card's decode steps against the
      CPU's (outputs and final states) and against the card's own
      prefill of those tokens (the recurrent form against the
      chunkwise one), within 1e-3;
    * end to end over a prefix: the CPU's chain, the card's, and the
      card's with its embeddings perturbed by 1e-7 (the witness of the
      card's own sensitivity), each closed by the final norm and the head
      after each of the first ``XLSTM_PREFIX_MAX`` layers.  Every prefix
      up to the first whose witness moves the logits by more than
      ``WITNESS_SHARE`` of the largest (a quarter of the tolerance: past
      it the layers have amplified rounding towards the tolerance) holds
      the card within 1e-3 of the largest logit; at least the first
      ``XLSTM_PREFIX_MIN`` layers must qualify;
    * at full depth, through the entry point: the card's distance from
      the CPU must be of the witness's order (at most 10x it)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    def rel(a, b):
        return float((a.cpu() - b.cpu()).abs().max()) / max(float(b.abs().max()), 1e-30)

    def head(p, h):
        return (L.norm_apply(p["final_norm"], h, cfg) @ T._head(p, cfg, h.dtype)).cpu()

    worst = {"prefill": 0.0, "decode": 0.0, "decode_state": 0.0, "decode_vs_prefill": 0.0}
    prefixes = []
    zero = torch.zeros((1,), dtype=torch.int32)
    with torch.inference_mode():
        x = T.embed_tokens(host_p, tokens, cfg)
        xg = T.embed_tokens(card_p, tokens.to(dev), cfg)
        noise = torch.randn(xg.shape, generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
        xp = xg * (1 + 1e-7 * noise)
        for p in range(cfg.n_periods):
            for s, kind in enumerate(cfg.block_pattern):
                pc = T._index(host_p["body"][f"slot{s}"], p)
                pg = T._index(card_p["body"][f"slot{s}"], p)
                y = T._slot_apply(kind, pc, x, cfg)
                worst["prefill"] = max(worst["prefill"],
                                       rel(T._slot_apply(kind, pg, x.to(dev), cfg), y))
                xg = T._slot_apply(kind, pg, xg, cfg)
                xp = T._slot_apply(kind, pg, xp, cfg)
                xs = x[:, :tf_tokens]
                pre = T._slot_apply(kind, pg, xs.to(dev), cfg)
                st_c = T._state_init(kind, cfg, 1, tf_tokens, "cpu")
                st_g = T._state_init(kind, cfg, 1, tf_tokens, dev)
                dec_c, dec_g = [], []
                for t in range(tf_tokens):
                    dec_c.append(T._slot_decode(kind, pc, xs[:, t:t + 1], st_c, zero, cfg))
                    dec_g.append(T._slot_decode(kind, pg, xs[:, t:t + 1].to(dev), st_g,
                                                zero.to(dev), cfg))
                dec_c, dec_g = torch.cat(dec_c, 1), torch.cat(dec_g, 1)
                worst["decode"] = max(worst["decode"], rel(dec_g, dec_c))
                worst["decode_state"] = max(worst["decode_state"], *(
                    rel(a, b) for a, b in zip(leaves(st_g), leaves(st_c))))
                worst["decode_vs_prefill"] = max(worst["decode_vs_prefill"], rel(dec_g, pre))
                x = y
                if len(prefixes) < XLSTM_PREFIX_MAX:
                    want, got = head(host_p, x), head(card_p, xg)
                    prefixes.append({"layers": len(prefixes) + 1,
                                     "max_abs_logit": float(want.abs().max()),
                                     "max_abs_card_cpu": float((got - want).abs().max()),
                                     "max_abs_card_perturbed_1e-7":
                                         float((head(card_p, xp) - got).abs().max())})
        perturbed = head(card_p, xp)
    for k, v in worst.items():
        check(v <= 1e-3, f"{cfg.name} layerwise {k}: card vs reference differ by {v} of the "
              "layer's largest output > 1e-3")
    held = 0
    for r in prefixes:
        if r["max_abs_card_perturbed_1e-7"] > WITNESS_SHARE * r["max_abs_logit"]:
            break
        check(r["max_abs_card_cpu"] <= 1e-3 * r["max_abs_logit"],
              f"{cfg.name} first {r['layers']} layers: f32 logits card vs cpu differ by "
              f"{r['max_abs_card_cpu']} > 1e-3 x {r['max_abs_logit']}")
        held = r["layers"]
    check(held >= XLSTM_PREFIX_MIN, f"{cfg.name}: the card's own witness exceeds {WITNESS_SHARE} "
          f"of the largest logit within {held + 1} layers, so no prefix of {XLSTM_PREFIX_MIN} "
          f"layers can be held: {prefixes}")
    e2e = float((card_logits - cpu_logits).abs().max())
    witness = float((perturbed - card_logits).abs().max())
    check(e2e <= 10 * witness, f"{cfg.name} end to end: card vs cpu {e2e} is more than 10x the "
          f"card's own witness {witness}")
    return {"layerwise_max_rel_err": worst, "tolerance_rel": 1e-3, "tf_tokens": tf_tokens,
            "prefixes": prefixes, "prefix_layers_held": held, "witness_share": WITNESS_SHARE,
            "end_to_end_max_abs_card_cpu": e2e, "end_to_end_max_abs_card_perturbed_1e-7": witness,
            "max_abs_logit": float(cpu_logits.abs().max())}


SERVE_REQUESTS = 8     # requests of the recurrent serving runs
PROMPT_CAP = 32        # prompt tokens a request (its evidence prompt cut to this)
SERVE_NEW_TOKENS = 16


def served(eng, cfg, log: dict) -> None:
    """Wrap ``eng``'s serve step: CUDA events around every call (prefill
    and decode apart, read after the run), and for each decode step each
    decoding lane's logits (on the card) under its request's id."""
    import torch
    serve, prefill = eng._serve, eng._prefill
    state = {"prefill": False}

    def logged_serve(params_, st, batch):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        nxt, logits, st = serve(params_, st, batch)
        ev[1].record()
        log["prefill" if state["prefill"] else "decode"].append(ev)
        if not state["prefill"]:
            for i, on in enumerate(eng._decoding):
                if on:
                    log["logits"].setdefault(eng.slots[i].rid, []).append(
                        logits[i, :cfg.vocab].float().clone())
        return nxt, logits, st

    def flagged_prefill(slot, req):
        state["prefill"] = True
        try:
            prefill(slot, req)
        finally:
            state["prefill"] = False
        log["prompt_tokens"] += int(eng.lengths[slot])
    eng._serve, eng._prefill = logged_serve, flagged_prefill


def count_waves(dev_eng) -> dict:
    """Count the DeviceEngine's kernel calls: each ``_lookup_rows`` of a
    non-empty batch is one path_lookup launch, each ``_q4_search`` one
    prefix_search launch."""
    calls = {"path_lookup": 0, "prefix_search": 0}
    lookup, search = dev_eng._lookup_rows, dev_eng._q4_search

    def counted_lookup(st, digest_pairs, table=None):
        calls["path_lookup"] += digest_pairs.shape[0] > 0
        return lookup(st, digest_pairs, table)

    def counted_search(prefixes, limit):
        calls["prefix_search"] += 1
        return search(prefixes, limit)
    dev_eng._lookup_rows, dev_eng._q4_search = counted_lookup, counted_search
    return calls


def recurrent_serving(dev, cfg, params, tag, batch=4, max_len=512) -> dict:
    """``cfg`` (as the ``ssm``/``xlstm`` phase cut it) through the
    ServingEngine with the heuristic oracle over the AuthTrace wiki in a
    DeviceEngine on the card: SERVE_REQUESTS requests at B=``batch``,
    max_len ``max_len``, each prompt cut to PROMPT_CAP tokens, with the
    launches counted from zero and checked exactly (the model kernels per
    serve call, path_lookup and prefix_search per engine call).  Then each
    request alone on a fresh ServingEngine, twice:

    * at B=``batch``, the other lanes idle: the same products at the same
      shapes, so the batched run's logits must be these to the bit (a
      lane's state leaking into another's, or a prefill stepping another
      lane, shows here);
    * at B=1: the bf16 products round otherwise at one row than at four,
      and random weights amplify that to the logits' own size over 16-24
      layers (the ``xlstm_parity`` witness; the CPU tests' bf16 runs of
      two packages 2.41 apart on jamba's logits), so greedy tokens may
      part early: the first flip of each request is reported through
      ``first_flip``, whose tolerance (the alone run's top-2 gap within the
      two runs' difference at that step) holds it to a rounding flip.  In
      f32 the tokens are equal batched, alone at B=1 and on the CPU
      (``tests/test_torch_cuda.py``).

    Returns the batched run's launch counts."""
    import gc

    import torch
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.oracle import HeuristicOracle
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.kernels import ops
    from repro_torch.runtime.serving import Request, ServingEngine
    pipe, docs, questions = authtrace_wiki(160, 0)
    tok = HashTokenizer(vocab_size=cfg.vocab).fit([d["text"] for d in docs])
    full_encode = tok.encode
    tok.encode = lambda text: full_encode(text)[:PROMPT_CAP]
    dev_eng = DeviceEngine.from_store(pipe.store, device=dev)
    waves = count_waves(dev_eng)

    def requests():
        return [Request(rid=q.qid, query=q.text, max_new_tokens=SERVE_NEW_TOKENS)
                for q in questions[:SERVE_REQUESTS]]

    def run(b, reqs):
        eng = ServingEngine(cfg, params, tok, dev_eng, HeuristicOracle(), batch_size=b,
                            max_len=max_len, device=dev)
        log = {"prefill": [], "decode": [], "logits": {}, "prompt_tokens": 0}
        served(eng, cfg, log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        log["wall_s"] = time.perf_counter() - t0
        check(len(done) == len(reqs), f"{tag} serving: {len(done)} of {len(reqs)} requests done")
        return log

    def alone(b):
        out = {"prefill": [], "decode": [], "logits": {}, "wall_s": 0.0}
        for r in requests():
            one = run(b, [r])
            for key in ("prefill", "decode"):
                out[key] += one[key]
            out["logits"].update(one["logits"])
            out["wall_s"] += one["wall_s"]
        return out

    def stacked(log, rid):
        return torch.stack(log["logits"][rid]).cpu()

    torch.cuda.reset_peak_memory_stats()
    waves.update(path_lookup=0, prefix_search=0)
    # the main path: counts from zero, the batched run, read just after
    ops.reset_launches()
    batched = run(batch, requests())
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = len(batched["prefill"]) + len(batched["decode"])
    per_step = {k: v[1] for k, v in path_launches(cfg).items()}
    want = {**dict.fromkeys(counts, 0), **{k: per_step[k] * calls for k in per_step}, **waves}
    check(counts == want, f"{tag} serving launches {counts} != {want} ({calls} serve calls)")

    same_shape, one_row = alone(batch), alone(1)
    flips, first_diff, scale = {}, 0.0, 0.0
    for rid in one_row["logits"]:
        o, a4, a1 = stacked(batched, rid), stacked(same_shape, rid), stacked(one_row, rid)
        check(o.shape == a4.shape == a1.shape, f"{tag} serving {rid}: {o.shape[0]} tokens in "
              f"the batch, {a4.shape[0]} and {a1.shape[0]} alone")
        check(torch.equal(o, a4), f"{tag} serving {rid}: the batched logits differ from the "
              f"same request's alone at B={batch} by {float((o - a4).abs().max())}")
        flip = first_flip([(a1, a1.argmax(-1, keepdim=True))], [(o, o.argmax(-1, keepdim=True))],
                          1)
        if flip is not None:
            flips[rid] = {**flip, "max_abs_logit": float(a1[flip["token"]].abs().max())}
        first_diff = max(first_diff, float((a1[0] - o[0]).abs().max()))
        scale = max(scale, float(a1[0].abs().max()))

    def ms(events):
        return [e[0].elapsed_time(e[1]) for e in events]
    dec_ms, pre_ms = ms(batched["decode"]), ms(batched["prefill"])
    out = {"phase": "recurrent_serving", "arch": cfg.name, "layers": cfg.n_layers,
           "batch": batch, "max_len": max_len, "requests": SERVE_REQUESTS,
           "prompt_cap": PROMPT_CAP, "new_tokens": SERVE_NEW_TOKENS,
           "cuts": [f"layers {cfg.n_layers}", f"prompts cut to {PROMPT_CAP} tokens",
                    f"{SERVE_REQUESTS} requests"],
           "serve_calls": calls, "prefill_calls": len(pre_ms), "decode_steps": len(dec_ms),
           "prompt_tokens": batched["prompt_tokens"],
           "decode_step_ms": statistics.median(dec_ms),
           "decode_step_ms_mean": statistics.mean(dec_ms),
           "prefill_ms_per_prompt_token": sum(pre_ms) / max(batched["prompt_tokens"], 1),
           "prefill_share_of_serve_ms": sum(pre_ms) / (sum(pre_ms) + sum(dec_ms)),
           "wall_s": batched["wall_s"], "requests_per_s": SERVE_REQUESTS / batched["wall_s"],
           "alone_wall_s": {f"B={batch}": same_shape["wall_s"], "B=1": one_row["wall_s"]},
           "alone_decode_step_ms": {f"B={batch}": statistics.median(ms(same_shape["decode"])),
                                    "B=1": statistics.median(ms(one_row["decode"]))},
           "peak_gib": peak, "launches": counts,
           "per_serve_call": {k: per_step[k] for k in per_step},
           f"equal_to_alone_at_B={batch}": "logits bit for bit",
           "tokens_equal_to_alone_at_B=1": not flips, "requests_with_a_flip_at_B=1": len(flips),
           "flips_at_B=1": flips, "first_token_max_abs_logit_diff_at_B=1": first_diff,
           "first_token_max_abs_logit": scale, "nvidia_smi": nvidia_smi()}
    emit(out)
    # the engines' wrapped serve steps close over their engines (cycles
    # that hold the weights until collected)
    del batched, same_shape, one_row, dev_eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def recurrent_phase(dev, arch, layers, seed=0, seq=4096, dec_batch=4, dec_len=512, dec_steps=16,
                    parity_seq=None, tf_tokens=16) -> dict:
    """(a) ``arch`` at full width, cut to ``layers`` layers, weights drawn
    on the card from ``seed``: one prefill and one eval at B=1, S=``seq``,
    then ``dec_steps`` serve steps at B=``dec_batch`` (ragged lengths,
    max_len ``dec_len``), the launches counted and checked against
    ``RECURRENT_LAUNCHES``; their times beside their bounds, and the
    prefill's split (the scans per layer, timed alone, against the rest).
    (b) f32 parity of the card with the CPU.  jamba cut to its period's
    first four slots (mamba, mamba+MoE, mamba, attention+MoE; the first
    two when the host is short of memory) at S=128: logits within 1e-3 of
    the largest, router indices equal but at near ties, the bf16 run's
    share of changed expert assignments, and teacher-forced decode of
    ``tf_tokens`` tokens against the prefill at capacity_factor 64
    (``moe_parity``).  xlstm at all its layers at S=512
    (``blockwise_parity``: its layers amplify rounding)."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as X
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    tag = "ssm" if arch.startswith("jamba") else "xlstm"
    m = cfg.moe
    want = RECURRENT_LAUNCHES[arch]
    check(path_launches(cfg) == want, f"{arch}: the config's launches {path_launches(cfg)} "
          f"!= the table's {want}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    w_bytes = nbytes(params)
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
    check(bool(torch.isfinite(logits).all()), f"non-finite {arch} prefill logits")
    check(math.isfinite(loss) and loss > 0, f"{arch} eval loss {loss}")
    del logits
    fwd = dict(ops.LAUNCHES)
    for _ in range(dec_steps):
        tk, dec_logits, state = serve(params, state, {"tokens": tk, "lengths": lens})
        lens = lens + 1
    check(bool(torch.isfinite(dec_logits[:, :cfg.vocab]).all()), "non-finite decode logits")
    counts = dict(ops.LAUNCHES)
    dec = {k: counts[k] - fwd[k] for k in counts}
    for name, (per_fwd, per_step) in want.items():
        check(fwd[name] == 2 * per_fwd and dec[name] == dec_steps * per_step,
              f"{arch} {name} launches {fwd[name]} (2 forwards) / {dec[name]} ({dec_steps} "
              f"decode steps) != {2 * per_fwd} / {dec_steps * per_step}")
    check(sum(counts[k] for k in counts if k not in want) == 0, f"{arch}: other launches {counts}")

    eval_ms = cuda_ms(lambda: evals(params, batch), iters=3, warmup=1)
    step = {"tokens": tk, "lengths": lens - 1}      # the last step again, in place
    _, log_dec = logged_run(lambda: serve(params, state, step))
    decode_ms = cuda_ms(lambda: serve(params, state, step), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30

    # where the prefill's time goes: each scan of one layer at the prefill
    # shape, timed alone (outside the count), and jamba's MoE FFN and flash
    kinds = list(cfg.block_pattern) * cfg.n_periods

    def split_parts() -> dict:
        """One layer's parts at the prefill shape, as callables (their
        inputs are freed with them)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        act = getattr(torch, cfg.dtype)
        D = cfg.d_model
        split = {}
        if "mamba" in kinds:
            Din, N = cfg.ssm_expand * D, cfg.d_state
            ssm0 = tree_map(lambda t: t[0], params["body"]["slot0"]["ssm"])
            u = torch.randn((1, seq, Din), generator=gen, device=dev)
            dt = SSM._softplus(torch.randn((1, seq, Din), generator=gen, device=dev) - 4.0)
            bc = torch.randn((2, 1, seq, N), generator=gen, device=dev)
            split["mamba_scan_per_layer"] = \
                lambda: SSM._ssm_core(u, dt, bc[0], bc[1], ssm0["A_log"], ssm0["D_skip"])
        if "mlstm" in kinds:
            Hx = cfg.xlstm_heads
            Dhx = 2 * D // Hx
            qkv = torch.randn((3, 1, Hx, seq, Dhx), generator=gen, device=dev)
            gates = torch.randn((2, 1, Hx, seq), generator=gen, device=dev)
            log_f = torch.nn.functional.logsigmoid(gates[1] + 3.0)
            st0 = X.mlstm_state_init_raw(1, Hx, Dhx, dev)
            split["mlstm_scan_per_layer"] = \
                lambda: X.mlstm_chunkwise(qkv[0], qkv[1], qkv[2], gates[0], log_f, st0,
                                          chunk=X._pick_chunk(seq))
        if "slstm" in kinds:
            s_slot = f"slot{cfg.block_pattern.index('slstm')}"
            sl0 = tree_map(lambda t: t[0], params["body"][s_slot]["slstm"])
            xin = torch.randn((1, seq, 4 * D), generator=gen, device=dev)
            split["slstm_scan_per_layer"] = lambda: X._slstm_scan(
                xin, sl0["w_h"], sl0["bias"], X.slstm_state_init(cfg, 1, dev), act)
        if m is not None:
            m_slot = next(f"slot{s}" for s in range(len(cfg.block_pattern))
                          if T._slot_is_moe(cfg, s))
            moe0 = tree_map(lambda t: t[0], params["body"][m_slot]["moe"])
            h = torch.randn((seq, D), generator=gen, device=dev).to(act)
            split["moe_ffn_per_layer"] = lambda: MoE.moe_apply_local(moe0, h, cfg)
        if "attn" in kinds:
            q = torch.randn((1, cfg.n_heads, seq, cfg.head_dim), generator=gen,
                            device=dev).to(act)
            kv = torch.randn((2, 1, cfg.n_kv_heads, seq, cfg.head_dim), generator=gen,
                             device=dev).to(act)
            split["flash_per_layer"] = lambda: ops.attention(q, kv[0], kv[1], causal=True)
        return split

    # timed in turns with the whole prefill, and under inference mode as
    # the prefill runs them: the loops are host-bound, and outside it every
    # in-place step on a view also pays autograd's view and version
    # bookkeeping on the host
    with torch.inference_mode():
        split = interleaved_ms({"prefill": lambda: prefill(params, batch), **split_parts()},
                               rounds=3)
    prefill_ms = split.pop("prefill")
    n_of = {"mamba_scan_per_layer": kinds.count("mamba"),
            "mlstm_scan_per_layer": kinds.count("mlstm"),
            "slstm_scan_per_layer": kinds.count("slstm"),
            "moe_ffn_per_layer": want["moe_router"][0],
            "flash_per_layer": kinds.count("attn")}
    totals = {k.replace("_per_layer", ""): n_of[k] * v for k, v in split.items()}
    scans = sum(v for k, v in totals.items() if k.endswith("_scan"))
    breakdown = {**split, **totals, "scans": scans,
                 "rest": prefill_ms - sum(totals.values())}

    # bounds.  Prefill: operations (bf16 products at the bf16 peak, the
    # scans' float32 work at the f32 peak; the experts counted for the
    # assignments kept under capacity).  A decode step: bytes (every
    # weight but an untied embedding and the unrouted experts, the
    # recurrent states read and written, the live KV caches).
    kept, routed, expert_bytes, n_moe = 0, [], 0, want["moe_router"][0]
    if m is not None:
        cap = MoE._capacity(seq, m.top_k, m.n_experts, m.capacity_factor)
        kept = sum(int(torch.bincount(idx.flatten().long(), minlength=m.n_experts)
                       .clamp(max=cap).sum()) for _, idx in log_pre)
        routed = [len(set(idx.flatten().tolist())) for _, idx in log_dec]
        check(len(log_pre) == len(log_dec) == n_moe, "router calls per forward / step")
        elt = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
        expert_bytes = 3 * cfg.d_model * m.d_ff_expert * elt
    bf16_ops, f32_ops = recurrent_prefill_ops(cfg, seq, kept)
    b_pre, by_pre = mixed_bound(w_bytes, bf16_ops, f32_ops)
    emb_bytes = nbytes(params["embed"])
    n_attn = kinds.count("attn")
    kv_bytes = 2 * n_attn * cfg.n_kv_heads * cfg.head_dim * 2 * sum(n + dec_steps for n in lens0)
    st_bytes = recurrent_state_bytes(cfg, dec_batch)
    w_dec = w_bytes - (0 if cfg.tie_embeddings else emb_bytes) \
        - (n_moe * m.n_experts * expert_bytes if m is not None else 0) + expert_bytes * sum(routed)
    dec_bytes = w_dec + kv_bytes + st_bytes
    # each weight read is one multiply-add a lane (bf16: 2 bytes a weight)
    b_dec, by_dec = bound(dec_bytes, 2.0 * dec_batch * w_dec / 2, BF16_FLOPS)
    emit({"phase": tag, "arch": cfg.name, "layers": layers, "of": full.n_layers,
          "params_b": n_params / 1e9, "weights_gib": w_bytes / 2**30, "init_s": t_init,
          "seq": seq, "loss": loss, "launches": counts,
          "per_forward": {k: fwd[k] // 2 for k in want},
          "per_decode_step": {k: dec[k] // dec_steps for k in want},
          "prefill_ms": prefill_ms, "prefill_tokens_per_s": seq / prefill_ms * 1e3,
          "eval_ms": eval_ms, "decode_batch": dec_batch, "decode_step_ms": decode_ms,
          "peak_gib": peak, "prefill_assignments_kept": kept,
          "prefill_bf16_tflop": bf16_ops / 1e12, "prefill_f32_tflop": f32_ops / 1e12,
          "prefill_bound_ms": b_pre, "prefill_bound_by": by_pre,
          "decode_experts_routed": routed, "decode_state_mb": st_bytes / 1e6,
          "decode_gb": dec_bytes / 1e9, "decode_bound_ms": b_dec, "decode_bound_by": by_dec,
          "prefill_breakdown_ms": breakdown})

    # (c) the ServingEngine over the same weights, its own counts from zero
    del state, dec_logits, step
    torch.cuda.empty_cache()
    serve_counts = recurrent_serving(dev, cfg, params, tag)
    counts = {k: counts[k] + serve_counts[k] for k in counts}

    # (b) parity, the rest of the card's weights freed
    if m is not None:
        # f32 bytes of the period's first four slots, the embedding and the head
        first4 = sum(nbytes(params["body"][f"slot{s}"]) for s in range(4)) // cfg.n_periods
        f32_bytes = 2 * (w_bytes - nbytes(params["body"]) + first4)
        n_slots = 4 if host_mem_available() >= 1.5 * f32_bytes else 2
        cfg_p = dataclasses.replace(cfg, n_layers=n_slots,
                                    block_pattern=cfg.block_pattern[:n_slots])
        small = {**params, "body": {f"slot{s}": tree_map(lambda t: t[:1].clone(),
                                                         params["body"][f"slot{s}"])
                                    for s in range(n_slots)}}
        del params
        torch.cuda.empty_cache()
        out = moe_parity(dev, cfg_p, small, toks, parity_seq or 128, tf_tokens)
        emit({"phase": f"{tag}_parity", "arch": cfg.name, "layers": cfg_p.n_layers,
              "block_pattern": list(cfg_p.block_pattern),
              "layers_note": None if n_slots == 4 else "2 slots: the host is short of memory",
              **out})
        return counts
    par_seq = parity_seq or 512
    card32_p = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    fwd32 = M.make_prefill_step(dataclasses.replace(cfg, dtype="float32", param_dtype="float32"))
    tokens = torch.from_numpy(toks[:, :par_seq])
    card = fwd32(card32_p, {"tokens": tokens.to(dev)}).cpu()
    host32 = tree_map(lambda t: t.cpu(), card32_p)
    t0 = time.perf_counter()
    cpu = fwd32(host32, {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    out = blockwise_parity(dev, dataclasses.replace(cfg, dtype="float32", param_dtype="float32"),
                           card32_p, host32, tokens, tf_tokens, card, cpu)
    del card32_p, host32
    torch.cuda.empty_cache()
    emit({"phase": f"{tag}_parity", "arch": cfg.name, "layers": cfg.n_layers, "seq": par_seq,
          "mlstm_chunk": X._pick_chunk(par_seq), "dtype": "float32 (bf16 weights upcast)",
          "cpu_forward_s": cpu_s, **out})
    return counts


# ---------------------------------------------------------------------------
# phase 13: the encoder-decoder and vision paths — whisper-medium and
# internvl2-1b at full width and depth
# ---------------------------------------------------------------------------
# whisper-medium's context sizes (OpenAI's ModelDimensions for medium:
# n_audio_ctx 1500 frames, n_text_ctx 448 tokens)
AUDIO_CTX, TEXT_CTX = 1500, 448


def encdec_launches(cfg) -> tuple[dict, dict, dict]:
    """(per forward, per encoder pass, per decode step) launches of each
    model kernel of an encoder-decoder, counted from the config: an
    encoder block has two norms and one non-causal flash_attention, a
    decoder block three norms (norm_x before its cross-attention) and two
    flash_attention (causal self, non-causal cross), each stack ends in
    the shared final norm; a decode step runs decode_attention and the
    cross-attention's flash_attention in every block."""
    Ld, Le = cfg.n_layers, cfg.n_enc_layers
    enc = {"rmsnorm": 2 * Le + 1, "flash_attention": Le}
    return ({"rmsnorm": enc["rmsnorm"] + 3 * Ld + 1, "flash_attention": Le + 2 * Ld}, enc,
            {"rmsnorm": 3 * Ld + 1, "flash_attention": Ld, "decode_attention": Ld})


def attn_layer_flops(cfg, S: int, Skv: int, causal: bool) -> float:
    """One attention block's products at B=1: the four projections,
    attention over ``Skv`` keys (the visible pairs when causal) and the
    gated MLP."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pairs = S * (S + 1) / 2 if causal else S * Skv
    return 2.0 * S * D * (2 * H * Dh + 2 * KV * Dh) + 4.0 * Dh * H * pairs + 6.0 * S * D * cfg.d_ff


def cross_flops(cfg, S: int, Se: int) -> float:
    """One cross-attention at B=1: q and o over the ``S`` queries, k and v
    over the ``Se`` encoder positions (recomputed at every decode step, as
    the reference does), non-causal attention."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return 2.0 * S * D * 2 * H * Dh + 2.0 * Se * D * 2 * KV * Dh + 4.0 * Dh * H * S * Se


def check_launches(tag: str, got: dict, want: dict) -> None:
    """``got`` (LAUNCHES differences) equals ``want``, every other kernel 0."""
    full = {k: want.get(k, 0) for k in got}
    check(got == full, f"{tag} launches {got} != {full}")


def encdec_phase(dev, seed=0, batch=4, n_frames=AUDIO_CTX, n_tok=TEXT_CTX, dec_steps=16,
                 parity=((256, 64), (64, 128)), tf_tokens=16) -> dict:
    """(a) whisper-medium at full width and depth (24 encoder and 24
    decoder layers, bf16, weights drawn on the card from ``seed``): one
    prefill and one eval at B=``batch`` over frames (B, ``n_frames``,
    1024) and tokens (B, ``n_tok``), the encoder's output of the same
    frames, then ``dec_steps`` serve steps at B=``batch`` (ragged lengths,
    max_len ``n_tok``), each given that output as ``enc_out`` — the
    launches counted and checked exactly; their times beside their bounds,
    the flash_attention of one layer of each kind timed alone, and the
    peak memory.  (b) ``encdec_parity``: 2 encoder and 2 decoder layers in
    f32 on the card and on the CPU."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_config("whisper-medium")
    per_fwd, per_enc, per_step = encdec_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(gen, cfg)
    act = getattr(torch, cfg.dtype)
    frames = torch.randn((batch, n_frames, cfg.d_model), generator=gen, device=dev).to(act)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params, w_bytes = sum(t.numel() for t in tree_leaves(params)), nbytes(params)
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(batch, n_tok)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    b = {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev),
         "frames": frames}
    prefill, evals, serve = M.make_prefill_step(cfg), M.make_eval_step(cfg), M.make_serve_step(cfg)
    state = T.init_decode_state(cfg, batch, n_tok, dev)
    tk = torch.from_numpy(rs.randint(0, cfg.vocab, size=batch).astype(np.int32)).to(dev)
    lens0 = [0, n_tok // 5, n_tok // 2, n_tok - dec_steps][:batch]
    lens = torch.tensor(lens0, dtype=torch.int32, device=dev)

    def encode():
        with torch.inference_mode():
            return T._encode(params, frames, cfg)

    # the main path: counts from zero, one prefill, one eval, the encoder's
    # output for the decode steps, the decode steps; read just after
    ops.reset_launches()
    logits = prefill(params, b)
    loss = float(evals(params, b))
    check(tuple(logits.shape) == (batch, n_tok, cfg.padded_vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite whisper prefill logits")
    check(math.isfinite(loss) and loss > 0, f"whisper eval loss {loss}")
    del logits
    fwd = dict(ops.LAUNCHES)
    enc_out = encode()
    enc = {k: ops.LAUNCHES[k] - fwd[k] for k in fwd}
    before = dict(ops.LAUNCHES)
    for _ in range(dec_steps):
        tk, dec_logits, state = serve(params, state, {"tokens": tk, "lengths": lens,
                                                      "enc_out": enc_out})
        lens = lens + 1
    check(bool(torch.isfinite(dec_logits[:, :cfg.vocab]).all()), "non-finite decode logits")
    counts = dict(ops.LAUNCHES)
    dec = {k: counts[k] - before[k] for k in counts}
    check_launches("whisper 2 forwards", fwd, {k: 2 * v for k, v in per_fwd.items()})
    check_launches("whisper encoder", enc, per_enc)
    check_launches(f"whisper {dec_steps} decode steps", dec,
                   {k: dec_steps * v for k, v in per_step.items()})

    prefill_ms = cuda_ms(lambda: prefill(params, b), iters=3, warmup=1)
    eval_ms = cuda_ms(lambda: evals(params, b), iters=3, warmup=1)
    encode_ms = cuda_ms(encode, iters=3, warmup=1)
    step = {"tokens": tk, "lengths": lens - 1, "enc_out": enc_out}   # the last step again
    decode_ms = cuda_ms(lambda: serve(params, state, step), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one flash_attention of each kind at the path's shapes, alone
    H, Dh = cfg.n_heads, cfg.head_dim
    qe = torch.randn((batch, H, n_frames, Dh), generator=gen, device=dev).to(act)
    qd = torch.randn((batch, H, n_tok, Dh), generator=gen, device=dev).to(act)
    flash = {"encoder_self_per_layer": cuda_ms(lambda: ops.attention(qe, qe, qe, causal=False),
                                               iters=5, warmup=1),
             "decoder_self_per_layer": cuda_ms(lambda: ops.attention(qd, qd, qd, causal=True),
                                               iters=5, warmup=1),
             "cross_per_layer": cuda_ms(lambda: ops.attention(qd, qe, qe, causal=False),
                                        iters=5, warmup=1),
             "cross_decode_per_layer": cuda_ms(lambda: ops.attention(qd[:, :, :1], qe, qe,
                                                                     causal=False),
                                               iters=10, warmup=2)}
    del qe, qd
    Ld, Le = cfg.n_layers, cfg.n_enc_layers
    flash.update({"encoder_self": Le * flash["encoder_self_per_layer"],
                  "decoder_self": Ld * flash["decoder_self_per_layer"],
                  "cross": Ld * flash["cross_per_layer"],
                  "decode_cross": Ld * flash["cross_decode_per_layer"]})
    # bounds.  A forward: operations (the encoder's and the decoder's
    # blocks, the cross-attention, the tied head), or the weights' bytes.
    # The encoder alone likewise.  A decode step: the larger of the bytes
    # (the decoder's weights, the embedding that the tied head reads, the
    # live KV caches, enc_out once) and the products (the decoder's
    # projections and MLP for one token a lane, the cross-attention with
    # its K and V recomputed over all frames, the head; attention over the
    # cache is under 0.1% of them and left out).
    D, V = cfg.d_model, cfg.padded_vocab
    enc_flops = batch * Le * attn_layer_flops(cfg, n_frames, n_frames, False)
    fwd_flops = enc_flops + batch * (Ld * (attn_layer_flops(cfg, n_tok, n_tok, True)
                                           + cross_flops(cfg, n_tok, n_frames))
                                     + 2.0 * n_tok * D * V)
    b_fwd, by_fwd = bound(w_bytes, fwd_flops, BF16_FLOPS)
    enc_bytes = nbytes(params["enc_body"])
    b_enc, by_enc = bound(enc_bytes + 2 * enc_out.numel() * enc_out.element_size(), enc_flops,
                          BF16_FLOPS)
    kv_bytes = 2 * Ld * cfg.n_kv_heads * Dh * 2 * sum(n + dec_steps for n in lens0)
    dec_bytes = w_bytes - enc_bytes + kv_bytes + enc_out.numel() * enc_out.element_size()
    dec_flops = batch * (Ld * (2.0 * D * (2 * H * Dh + 2 * cfg.n_kv_heads * Dh)
                               + 6.0 * D * cfg.d_ff + cross_flops(cfg, 1, n_frames))
                         + 2.0 * D * V)
    b_dec, by_dec = bound(dec_bytes, dec_flops, BF16_FLOPS)
    emit({"phase": "encdec", "arch": cfg.name, "encoder_layers": Le, "decoder_layers": Ld,
          "params_b": n_params / 1e9, "weights_gib": w_bytes / 2**30, "init_s": t_init,
          "batch": batch, "frames": n_frames, "tokens": n_tok, "loss": loss,
          "launches": counts, "per_forward": {k: fwd[k] // 2 for k in per_fwd},
          "per_encoder_pass": {k: enc[k] for k in per_enc}, "per_decode_step": {k: dec[k] // dec_steps for k in per_step},
          "prefill_ms": prefill_ms, "eval_ms": eval_ms, "encode_ms": encode_ms,
          "prefill_tokens_per_s": batch * (n_frames + n_tok) / prefill_ms * 1e3,
          "decode_step_ms": decode_ms, "decode_tokens_per_s": batch / decode_ms * 1e3,
          "decode_lengths": lens0, "peak_gib": peak,
          "prefill_tflop": fwd_flops / 1e12, "prefill_bound_ms": b_fwd, "prefill_bound_by": by_fwd,
          "encode_tflop": enc_flops / 1e12, "encode_bound_ms": b_enc, "encode_bound_by": by_enc,
          "decode_tflop": dec_flops / 1e12, "decode_gb": dec_bytes / 1e9,
          "decode_bound_ms": b_dec, "decode_bound_by": by_dec, "flash_ms": flash})

    # (b) parity on the first layers, the rest of the card's weights freed
    small = {"embed": params["embed"], "final_norm": params["final_norm"],
             "body": tree_map(lambda t: t[:2].clone(), params["body"]),
             "enc_body": tree_map(lambda t: t[:2].clone(), params["enc_body"])}
    del params, state, dec_logits, step, enc_out, frames, b
    torch.cuda.empty_cache()
    cfg_p = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2, dtype="float32",
                                param_dtype="float32")
    out = encdec_parity(dev, cfg_p, small, rs, parity, tf_tokens)
    emit({"phase": "encdec_parity", "arch": cfg.name, "encoder_layers": 2, "decoder_layers": 2,
          "dtype": "float32 (bf16 weights upcast)", "shapes": out})
    return counts


def teacher_forced(dev, cfg, params, tokens, extra: dict, enc_out=None) -> float:
    """Decode ``tokens`` (1, n) one at a time on the card (each step given
    ``enc_out``) and hold the logits to the prefill's over the same tokens
    (with ``extra`` inputs), within 1e-3 of its largest logit; returns
    the largest difference."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    n = tokens.shape[1]
    full = M.make_prefill_step(cfg)(params, {"tokens": tokens, **extra}).float().cpu()
    st, got = T.init_decode_state(cfg, 1, n, dev), []
    with torch.inference_mode():
        for t in range(n):
            lg, st = T.decode_step(params, st, tokens[:, t],
                                   torch.full((1,), t, dtype=torch.int32, device=dev), cfg,
                                   enc_out=enc_out)
            got.append(lg.float().cpu())
    err = float((torch.stack(got, dim=1) - full).abs().max())
    scale = float(full.abs().max())
    check(err <= 1e-3 * scale, f"{cfg.name} teacher-forced decode vs prefill differ by {err} "
          f"> 1e-3 x {scale}")
    return err


def encdec_parity(dev, cfg_p, small: dict, rs, shapes, tf_tokens: int) -> list:
    """f32 parity of whisper's first 2 encoder and 2 decoder layers (the
    card's bf16 weights ``small`` upcast, on the card and on the CPU) at
    each (frames, tokens) of ``shapes``, B=1: logits within 1e-3 of the
    largest; then teacher-forced decode of ``tf_tokens`` tokens against
    the prefill, each step given the encoder's output of the same frames.
    Frames fewer than tokens put more queries than keys in the
    cross-attention."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    card32 = tree_map(lambda t: t.float(), small)
    small.clear()
    host32 = tree_map(lambda t: t.cpu(), card32)
    fwd = M.make_prefill_step(cfg_p)
    out = []
    for n_frames, n_tok in shapes:
        frames = torch.from_numpy(rs.randn(1, n_frames, cfg_p.d_model).astype(np.float32))
        tokens = torch.from_numpy(rs.randint(0, cfg_p.vocab, size=(1, n_tok)).astype(np.int32))
        card = fwd(card32, {"tokens": tokens.to(dev), "frames": frames.to(dev)}).cpu()
        t0 = time.perf_counter()
        cpu = fwd(host32, {"tokens": tokens, "frames": frames})
        cpu_s = time.perf_counter() - t0
        scale = float(cpu.abs().max())
        err = float((card - cpu).abs().max())
        check(err <= 1e-3 * scale, f"whisper f32 logits at {n_frames} frames, {n_tok} tokens: "
              f"card vs cpu differ by {err} > 1e-3 x {scale}")
        tf, fr = tokens[:, :tf_tokens].to(dev), frames.to(dev)
        with torch.inference_mode():
            enc_out = T._encode(card32, fr, cfg_p)
        tf_err = teacher_forced(dev, cfg_p, card32, tf, {"frames": fr}, enc_out=enc_out)
        out.append({"frames": n_frames, "tokens": n_tok, "cross_more_queries": n_tok > n_frames,
                    "cpu_forward_s": cpu_s, "max_abs_card_cpu": err, "max_abs_logit": scale,
                    "tolerance": 1e-3 * scale, "teacher_forced_tokens": tf.shape[1],
                    "max_abs_decode_prefill": tf_err})
    del card32, host32
    torch.cuda.empty_cache()
    return out


def vlm_phase(dev, seed=0, n_text=3840, dec_batch=4, dec_len=512, dec_steps=16,
              parity_text=128, tf_tokens=16) -> dict:
    """(a) internvl2-1b at full width and depth (24 layers, 14 / 2 heads,
    bf16, weights drawn on the card from ``seed``): one prefill and one
    eval at B=1 over its 256 patch embeddings and ``n_text`` tokens (4096
    positions: prefill_32k cut to 4096, as qwen3's), then ``dec_steps``
    serve steps at B=``dec_batch`` (text only, as the reference decodes;
    ragged lengths, max_len ``dec_len``) — decode_attention at group 7 —
    the launches counted and checked exactly, their times beside their
    bounds and the peak memory.  (b) f32 parity of the first 2 layers with
    the CPU at 256 + ``parity_text`` positions, and teacher-forced decode
    against the prefill of the same weights under ``frontend="none"`` (the
    reference's decode never sees the prefix, ROADMAP §3)."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_config("internvl2-1b")
    want = path_launches(cfg)
    per_fwd, per_step = ({k: v[i] for k, v in want.items() if v[i]} for i in (0, 1))
    n_pfx = cfg.n_prefix_embeds
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(gen, cfg)
    act = getattr(torch, cfg.dtype)
    pe = torch.randn((1, n_pfx, cfg.d_model), generator=gen, device=dev).to(act)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params, w_bytes = sum(t.numel() for t in tree_leaves(params)), nbytes(params)
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(1, n_text)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((1, 1), -1, np.int32)], axis=1)
    b = {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev),
         "prefix_embeds": pe}
    S = n_pfx + n_text
    prefill, evals, serve = M.make_prefill_step(cfg), M.make_eval_step(cfg), M.make_serve_step(cfg)
    state = T.init_decode_state(cfg, dec_batch, dec_len, dev)
    tk = torch.from_numpy(rs.randint(0, cfg.vocab, size=dec_batch).astype(np.int32)).to(dev)
    lens0 = [0, dec_len // 5, dec_len // 2, dec_len - dec_steps][:dec_batch]
    lens = torch.tensor(lens0, dtype=torch.int32, device=dev)

    # the main path: counts from zero, one prefill, one eval and the decode
    # steps, read just after
    ops.reset_launches()
    logits = prefill(params, b)
    loss = float(evals(params, b))
    check(tuple(logits.shape) == (1, S, cfg.padded_vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite internvl2 prefill logits")
    check(math.isfinite(loss) and loss > 0, f"internvl2 eval loss {loss}")
    del logits
    fwd = dict(ops.LAUNCHES)
    for _ in range(dec_steps):
        tk, dec_logits, state = serve(params, state, {"tokens": tk, "lengths": lens})
        lens = lens + 1
    check(bool(torch.isfinite(dec_logits[:, :cfg.vocab]).all()), "non-finite decode logits")
    counts = dict(ops.LAUNCHES)
    dec = {k: counts[k] - fwd[k] for k in counts}
    check_launches("internvl2 2 forwards", fwd, {k: 2 * v for k, v in per_fwd.items()})
    check_launches(f"internvl2 {dec_steps} decode steps", dec,
                   {k: dec_steps * v for k, v in per_step.items()})

    prefill_ms = cuda_ms(lambda: prefill(params, b), iters=3, warmup=1)
    eval_ms = cuda_ms(lambda: evals(params, b), iters=3, warmup=1)
    step = {"tokens": tk, "lengths": lens - 1}      # the last step again, in place
    decode_ms = cuda_ms(lambda: serve(params, state, step), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((1, H, S, Dh), generator=gen, device=dev).to(act)
    kv = torch.randn((2, 1, KV, S, Dh), generator=gen, device=dev).to(act)
    flash_ms = cuda_ms(lambda: ops.attention(q, kv[0], kv[1], causal=True), iters=5, warmup=1)
    del q, kv
    # bounds.  Prefill: operations (the blocks over all S positions, the
    # tied head over them, as the forward computes it) or the weights'
    # bytes.  A decode step: bytes (every weight, the embedding read by the
    # tied head, the live KV caches) or its products.
    D, V, L_ = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    flops = L_ * attn_layer_flops(cfg, S, S, True) + 2.0 * S * D * V
    b_pre, by_pre = bound(w_bytes, flops, BF16_FLOPS)
    kv_bytes = 2 * L_ * KV * Dh * 2 * sum(n + dec_steps for n in lens0)
    dec_flops = dec_batch * (L_ * (2.0 * D * (2 * H * Dh + 2 * KV * Dh) + 6.0 * D * cfg.d_ff)
                             + 2.0 * D * V)
    b_dec, by_dec = bound(w_bytes + kv_bytes, dec_flops, BF16_FLOPS)
    emit({"phase": "vlm", "arch": cfg.name, "layers": L_, "params_b": n_params / 1e9,
          "weights_gib": w_bytes / 2**30, "init_s": t_init, "prefix_embeds": n_pfx,
          "text_tokens": n_text, "seq": S, "loss": loss, "launches": counts,
          "per_forward": {k: fwd[k] // 2 for k in per_fwd},
          "per_decode_step": {k: dec[k] // dec_steps for k in per_step},
          "prefill_ms": prefill_ms, "prefill_tokens_per_s": S / prefill_ms * 1e3,
          "eval_ms": eval_ms, "decode_batch": dec_batch, "decode_step_ms": decode_ms,
          "decode_lengths": lens0, "peak_gib": peak,
          "prefill_tflop": flops / 1e12, "prefill_bound_ms": b_pre, "prefill_bound_by": by_pre,
          "decode_gb": (w_bytes + kv_bytes) / 1e9, "decode_bound_ms": b_dec,
          "decode_bound_by": by_dec,
          "prefill_breakdown_ms": {"flash_per_layer": flash_ms, "flash": L_ * flash_ms,
                                   "rest": prefill_ms - L_ * flash_ms}})

    # (b) parity on the first 2 layers in f32, the rest freed
    cfg_p = dataclasses.replace(cfg, n_layers=2, dtype="float32", param_dtype="float32")
    card32 = {"embed": params["embed"].float(), "final_norm": tree_map(lambda t: t.float(),
                                                                       params["final_norm"]),
              "body": tree_map(lambda t: t[:2].float(), params["body"])}
    del params, state, dec_logits, step, b, pe
    torch.cuda.empty_cache()
    host32 = tree_map(lambda t: t.cpu(), card32)
    pe = torch.from_numpy(rs.randn(1, n_pfx, cfg.d_model).astype(np.float32))
    tokens = torch.from_numpy(toks[:, :parity_text])
    fwd32 = M.make_prefill_step(cfg_p)
    card = fwd32(card32, {"tokens": tokens.to(dev), "prefix_embeds": pe.to(dev)}).cpu()
    t0 = time.perf_counter()
    cpu = fwd32(host32, {"tokens": tokens, "prefix_embeds": pe})
    cpu_s = time.perf_counter() - t0
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    check(err <= 1e-3 * scale, f"internvl2 f32 logits card vs cpu differ by {err} > 1e-3 x {scale}")
    tf_err = teacher_forced(dev, dataclasses.replace(cfg_p, frontend="none"), card32,
                            tokens[:, :tf_tokens].to(dev), {})
    del card32, host32
    torch.cuda.empty_cache()
    emit({"phase": "vlm_parity", "arch": cfg.name, "layers": 2, "prefix_embeds": n_pfx,
          "text_tokens": parity_text, "dtype": "float32 (bf16 weights upcast)",
          "cpu_forward_s": cpu_s, "max_abs_card_cpu": err, "max_abs_logit": scale,
          "tolerance": 1e-3 * scale,
          "teacher_forced": {"tokens": tf_tokens, "against": "prefill, frontend none",
                             "max_abs_decode_prefill": tf_err}})
    return counts


# ---------------------------------------------------------------------------
# phase 14: the training path — the backward kernels, then wikikv-router and
# qwen3-1.7B training at full width
# ---------------------------------------------------------------------------
# (tag, B, Hq, Hkv, Sq, Skv, D, dtype, causal): the attention calls of
# the train steps below — the router's (B=8, S=128), qwen3-1.7B's (B=1,
# S=4096), whisper-medium's cross-attention, encoder and decoder (B=4,
# 448 tokens, 1500 frames), dbrx's group of 6, internvl2-1b's group of 7
# (256 + 3840 positions), jamba's 32 / 8 heads of 128 — a ragged Sq < Skv
# (qwen3's heads, 128 queries over 4096 keys), and two non-causal with
# more queries than keys (whisper's heads)
FLASH_BWD_SHAPES = [
    ("router", 8, 4, 2, 128, 128, 64, "float32", True),
    ("qwen3", 1, 16, 8, 4096, 4096, 128, "bfloat16", True),
    ("ragged", 1, 16, 8, 128, 4096, 128, "bfloat16", True),
    ("whisper cross", 4, 16, 16, 448, 1500, 64, "bfloat16", False),
    ("dbrx", 1, 48, 8, 1024, 1024, 128, "bfloat16", True),
    ("whisper encoder", 4, 16, 16, 1500, 1500, 64, "bfloat16", False),
    ("whisper decoder", 4, 16, 16, 448, 448, 64, "bfloat16", True),
    ("internvl2", 1, 14, 2, 4096, 4096, 64, "bfloat16", True),
    ("jamba", 1, 32, 8, 4096, 4096, 128, "bfloat16", True),
    ("non-causal Sq > Skv", 1, 16, 16, 1500, 448, 64, "bfloat16", False),
    ("ragged Sq > Skv", 1, 16, 16, 200, 77, 64, "float32", False),
    ("kimi-k2", 1, 64, 8, 4096, 4096, 112, "bfloat16", True),
    ("kimi-k2 ragged f32", 1, 8, 1, 300, 1037, 112, "float32", True),
]
# (tag, rows, D, dtype, scaled): the norms of the train steps below at
# their B*S rows and width — the router's (1024 rows), qwen3's block norms
# and its qk-norm, jamba's, xlstm's (S=2048), whisper's encoder (4 x 1500)
# and decoder (4 x 448), internvl2's, kimi-k2's (d_model 7168) — and a
# norm without scale
NORM_BWD_SHAPES = [
    ("router", 1024, 256, "float32", True),
    ("qwen3 block", 4096, 2048, "bfloat16", True),
    ("qwen3 qk-norm", 65536, 128, "bfloat16", True),
    ("jamba", 4096, 4096, "bfloat16", True),
    ("xlstm", 2048, 1024, "bfloat16", True),
    ("whisper encoder", 6000, 1024, "bfloat16", True),
    ("whisper decoder", 1792, 1024, "bfloat16", True),
    ("internvl2", 4096, 896, "bfloat16", True),
    ("kimi-k2", 4096, 7168, "bfloat16", True),
    ("no scale", 1024, 256, "float32", False),
]
# a gradient sums Sq * group (dK, dV) or Skv (dQ) products in f32 in
# another order than the plain version: f32 is held to 1e-4, bf16 outputs
# to the forward's bf16 tolerance
BWD_F32_TOL = dict(atol=1e-4, rtol=1e-4)


def check_grad(name, got, want, dtype) -> float:
    import torch
    tol = BF16_TOL if dtype == torch.bfloat16 else BWD_F32_TOL
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite gradient")
    err = max_err(got, want)
    check(torch.allclose(got.float(), want.float(), **tol),
          f"{name}: backward kernel and plain version disagree (max abs err {err})")
    return err


def library_grad(fn, inputs, dout):
    """The yardstick: autograd's backward of one PyTorch call ``fn`` (its
    forward run once, outside the timing), as a function of no arguments."""
    import torch
    leaves_ = [t.detach().requires_grad_(True) if t is not None else None for t in inputs]
    out = fn(*leaves_)
    wrt = [t for t in leaves_ if t is not None]
    return lambda: torch.autograd.grad(out, wrt, dout, retain_graph=True)


def backward_kernels(dev) -> dict:
    """flash_attention_bwd and rmsnorm_bwd against their plain versions
    (``ref.attention_bwd_ref``, ``ref.rmsnorm_bwd_ref``) at the training
    shapes, on the same inputs (the attention's o and lse from the
    forward kernel), timed beside the plain version, the autograd backward
    of the library call (SDPA, ``F.rms_norm``) and their bounds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device="cpu").manual_seed(3)
    flash_rows = []
    for tag, B, Hq, Hkv, Sq, Skv, D, dt, causal in FLASH_BWD_SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, Hq, Sq, D), generator=g).to(dev, dtype)
        k = torch.randn((B, Hkv, Skv, D), generator=g).to(dev, dtype)
        v = torch.randn((B, Hkv, Skv, D), generator=g).to(dev, dtype)
        do = torch.randn((B, Hq, Sq, D), generator=g).to(dev, dtype)
        o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
        _, want_lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
        lse_err = max_err(lse, want_lse)
        check(lse_err <= 1e-4 * max(1.0, float(want_lse.abs().max())),
              f"flash_attention lse ({tag}) differs by {lse_err}")
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        err = max(check_grad(f"flash_attention_bwd ({tag}) {n}", a, b, dtype)
                  for n, a, b in zip(("dq", "dk", "dv"), got, want))
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_bwd ({tag}) is not bit for bit repeatable")
        del got, want, again
        elt = q.element_size()
        _, fwd_flops = attn_work(B, Hq, Hkv, Sq, Skv, D, causal, elt)
        flops = 2.5 * fwd_flops        # 5 products of 2 * D a visible pair, the forward's 2
        nbytes = elt * (3 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D) + 4 * B * Hq * Sq \
            + elt * (B * Hq * Sq * D + 2 * B * Hkv * Skv * D)
        b, by = bound(nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
        n = 5 if Sq * Skv * Hq > (1 << 24) else 20
        ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal), iters=n)
        gm = graph_ms(lambda *a: fa.flash_attention_bwd(*a, causal=causal),
                      (q, k, v, o, lse, do), calls=4 if n == 5 else 20, replays=3)
        # bf16: the delta pre-pass and the wgmma body; f32: one kernel
        one_kernel_a_call(f"flash_attention_bwd ({tag})", gm,
                          2 if dtype == torch.bfloat16 else 1)
        mask = sdpa_mask(q, k, causal)
        lib = library_grad(lambda a, b_, c: sdpa(a, b_, c, causal, mask), (q, k, v), do)
        plain_ms = cuda_ms(lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal),
                           iters=3, warmup=1)
        lib_ms = cuda_ms(lib, iters=n)
        # the library's card time and ours by one instrument (the profiler)
        lib_dev = profiled_ms(lambda: lib(), (), 3)
        prof = profiled_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal),
                           (), 3)
        flash_rows.append({
            "shape": f"({tag}) B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} {dt} "
                     f"{'causal' if causal else 'non-causal'}",
            "geometry": fa.bwd_geometry(B, Hq, Hkv, Sq, Skv, dtype == torch.bfloat16,
                                        build.sm_count(0), causal)._asdict(),
            "exp_bound_ms": exp_bound_ms(2 * fwd_flops, D) if D <= 64 else None,
            "max_abs_err": err, "lse_max_abs_err": lse_err, "gflop": flops / 1e9,
            "ms": ms, "device_ms": gm["device_ms"], "device_ms_profiled": prof,
            "plain_ms": plain_ms, "library_ms": lib_ms, "library_device_ms": lib_dev,
            "bound_ms": b, "bound_by": by, "tflop_per_s": flops / ms / 1e9,
            "share_of_bound": b / ms, "vs_library": ms / lib_ms,
            "device_share_of_bound": b / gm["device_ms"] if gm["device_ms"] else None,
            "device_vs_library": prof / lib_dev if prof and lib_dev else None})
        del q, k, v, do, o, lse, lib
        torch.cuda.empty_cache()
    emit({"phase": "flash_attention_bwd", "tolerance_f32": BWD_F32_TOL, "shapes": flash_rows,
          "library": "autograd backward of scaled_dot_product_attention"})

    norm_rows = []
    for tag, rows, D, dt, scaled in NORM_BWD_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn((rows, D), generator=g).to(dev, dtype)
        dy = torch.randn((rows, D), generator=g).to(dev, dtype)
        s = torch.randn((D,), generator=g).to(dev, dtype) if scaled else None
        dx, ds = rn.rmsnorm_bwd(x, s, dy)
        wx, ws = ref.rmsnorm_bwd_ref(x, s, dy)
        err = check_grad(f"rmsnorm_bwd ({tag}) dx", dx, wx, dtype)
        if scaled:
            # dscale sums `rows` terms: its rounding grows with sqrt(rows)
            ds_err = max_err(ds, ws)
            check(torch.allclose(ds.float(), ws.float(), rtol=2e-2,
                                 atol=1e-4 * rows ** 0.5 * (100 if dtype == torch.bfloat16 else 1)),
                  f"rmsnorm_bwd ({tag}) dscale differs by {ds_err}")
            check(torch.equal(rn.rmsnorm_bwd(x, s, dy)[1], ds),
                  f"rmsnorm_bwd ({tag}) dscale is not bit for bit repeatable")
        elt = x.element_size()
        nbytes = 3 * rows * D * elt + (2 * D * s.element_size() if scaled else 0)
        b, by = bound(nbytes, 10 * rows * D, F32_FLOPS)
        ms = cuda_ms(lambda: rn.rmsnorm_bwd(x, s, dy))
        gm = graph_ms(rn.rmsnorm_bwd, (x, s, dy))
        one_kernel_a_call(f"rmsnorm_bwd ({tag})", gm)   # with or without a scale
        lib = library_grad(lambda a, w: F.rms_norm(a, (D,), w, eps=1e-6), (x, s), dy)
        lib_ms = cuda_ms(lib)
        lib_dev = profiled_ms(lambda: lib(), (), 10)
        prof = profiled_ms(lambda: rn.rmsnorm_bwd(x, s, dy), (), 10)
        norm_rows.append({
            "shape": f"({tag}) x ({rows}, {D}) {dt} {'with' if scaled else 'without'} scale",
            "geometry": dict(zip(("threads_a_row", "units_a_thread", "elements_a_unit",
                                  "blocks", "cluster"),
                                 rn.bwd_geometry(rows, D, elt, True, build.sm_count(0)))),
            "max_abs_err": err, "ms": ms, "device_ms": gm["device_ms"],
            "device_ms_profiled": prof,
            "plain_ms": cuda_ms(lambda: ref.rmsnorm_bwd_ref(x, s, dy)),
            "library_ms": lib_ms, "library_device_ms": lib_dev,
            "bound_ms": b, "bound_by": by, "gb_per_s": nbytes / ms / 1e6,
            "share_of_bound": b / ms, "vs_library": ms / lib_ms,
            "device_share_of_bound": b / gm["device_ms"] if gm["device_ms"] else None,
            "device_vs_library": prof / lib_dev if prof and lib_dev else None})
        del x, dy, s, dx, ds, wx, ws, lib
    torch.cuda.empty_cache()
    emit({"phase": "rmsnorm_bwd", "shapes": norm_rows,
          "library": "autograd backward of F.rms_norm"})
    return {
        "flash_attention_bwd": {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:94",
            "note": "the Pallas kernel has no backward: jax.value_and_grad of its jnp reference",
            **flash_rows[1], "shapes": flash_rows[:1] + flash_rows[2:]},
        "rmsnorm_bwd": {
            "name": "rmsnorm_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:37",
            "note": "the Pallas kernel has no backward: jax.value_and_grad of its jnp reference",
            **norm_rows[1], "shapes": norm_rows[:1] + norm_rows[2:]}}


TRAIN_LOSS_RTOL = 2e-3   # router losses, card against CPU, over 20 AdamW steps


def router_loop(device, ckpt_dir: str, total: int, every: int, seed=0):
    """A TrainLoop of the full-width wikikv-router on the AuthTrace
    pipeline at B = 8, S = 128, as examples/train_router.py builds it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_pipeline
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
    cfg = get_config("wikikv-router")
    pipeline, _ = build_pipeline(cfg.vocab, seq_len=128, global_batch=8, seed=seed)
    return TrainLoop(cfg, AdamWConfig(lr=3e-4),
                     TrainLoopConfig(total_steps=total, checkpoint_every=every,
                                     checkpoint_dir=ckpt_dir, log_every=10 ** 9),
                     pipeline, device=device, seed=seed)


def router_training(dev, steps=20) -> dict:
    """wikikv-router at full width: ``steps`` TrainLoop steps on the card
    (the launches counted) and the same steps on the CPU (plain
    versions), per-step losses within TRAIN_LOSS_RTOL and falling; then a
    crash and restart: 12 steps with a checkpoint at 8, a fresh loop that
    restores and runs to 12, bit for bit the uninterrupted 12-step run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.tree import leaves
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ops.reset_launches()
        card = router_loop(dev, f"{root}/card", steps, steps)
        m = card.run()
        counts = dict(ops.LAUNCHES)
        cpu = router_loop("cpu", f"{root}/cpu", steps, steps).run()
        diffs = [abs(a - b) / abs(b) for a, b in zip(m.losses, cpu.losses)]
        check(len(m.losses) == len(cpu.losses) == steps, "router: steps missing")
        check(all(math.isfinite(x) for x in m.losses), f"router: non-finite losses {m.losses}")
        check(max(diffs) <= TRAIN_LOSS_RTOL,
              f"router: card and CPU losses differ by {max(diffs)} (relative)")
        check(m.losses[-1] < m.losses[0], f"router: the loss did not fall {m.losses}")
        per_step = {k: v / steps for k, v in counts.items()}
        want = {**dict.fromkeys(counts, 0), **train_launches(card.cfg)}
        check(per_step == want, f"router: launches a step {per_step} != {want}")
        step_ms = statistics.median(m.step_times[1:]) * 1e3
        batch = card._batch()
        split = device_split(lambda: card._step(card.params, card.opt_state, batch), step_ms)

        # crash and restart on the card
        a = router_loop(dev, f"{root}/restart", 12, 8)
        a.run(n_steps=8)
        check(a.ckpt.latest_step() == 8, "router: no checkpoint at step 8")
        del a                                   # the crash: nothing but the checkpoint is kept
        b = router_loop(dev, f"{root}/restart", 12, 8)
        mb = b.run()
        whole = router_loop(dev, f"{root}/whole", 12, 8)
        mw = whole.run()
        check(b.step_no == 12 and len(mb.losses) == 4, "router: the restart did not resume at 8")
        bitwise = (mb.losses == mw.losses[8:]
                   and all(torch.equal(x, y) for x, y in zip(leaves(b.params),
                                                             leaves(whole.params)))
                   and all(torch.equal(x, y) for x, y in zip(leaves(b.opt_state),
                                                             leaves(whole.opt_state))))
        check(bitwise, "router: the restarted run is not bit for bit the uninterrupted one")
        out = {"phase": "train_router", "arch": "wikikv-router", "batch": 8, "seq": 128,
               "steps": steps, "losses_card": m.losses, "losses_cpu": cpu.losses,
               "max_rel_loss_diff": max(diffs), "tolerance_rel": TRAIN_LOSS_RTOL,
               "step_ms": step_ms, "step_ms_all": [t * 1e3 for t in m.step_times],
               "cpu_step_ms": statistics.median(cpu.step_times[1:]) * 1e3,
               "tokens_per_s": 8 * 128 / step_ms * 1e3, "launches_per_step": per_step,
               "step_split": split,
               "restart": {"resumed_at": 8, "final_step": b.step_no,
                           "losses_after_restart": mb.losses, "bitwise_equal": bitwise}}
        emit(out)
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def qwen3_training(dev, seed=0, steps=5, seq=4096, parity_layers=2, parity_seq=256) -> dict:
    """qwen3-1.7B at full width (28 layers, weights drawn on the card from
    ``seed``, bf16, AdamW f32 moments): ``steps`` train steps at B = 1,
    S = ``seq`` (``model_training``), a loss that falls and the model
    FLOPs' share of the bf16 peak; then ``train_qwen3_parity``: the same
    weights' first ``parity_layers`` layers upcast to f32 at S =
    ``parity_seq``, the loss and every gradient leaf, card against CPU."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("qwen3-1.7b")
    batch = text_batch(dev, cfg, 1, seq, seed)
    counts, line = model_training(dev, "train_qwen3", cfg, cfg, batch, steps,
                                  ["B=1", f"{steps} steps on one batch"], seed=seed)
    losses = line["losses"]
    check(losses[-1] < losses[0], f"qwen3: the loss did not fall {losses}")
    # model FLOPs: the port's ``model_flops`` (6 N_active a token: forward
    # and backward of every weight, the tied head included); beside it,
    # under its own name, that count plus attention's score products, 3
    # times the forward's 4 * D a visible pair
    from repro_torch.models import model as M
    model_flops = M.model_flops(cfg, M.ShapeSpec("train_qwen3", seq, 1, "train"))
    _, attn_fwd = attn_work(1, cfg.n_heads, cfg.n_kv_heads, seq, seq, cfg.head_dim, True, 2)
    with_attn = model_flops + 3 * cfg.n_layers * attn_fwd
    mfu = model_flops / (line["step_ms"] / 1e3) / BF16_FLOPS
    print(f"qwen3-1.7b train model FLOPs share of the bf16 peak: {mfu:.6f} "
          f"({model_flops / 1e12:.3f} TFLOP of models.model.model_flops in "
          f"{line['step_ms']:.2f} ms; with attention's products "
          f"{with_attn / 1e12:.3f} TFLOP, share "
          f"{with_attn / (line['step_ms'] / 1e3) / BF16_FLOPS:.6f}; {nvidia_smi()})", flush=True)

    # parity: the first layers of the same draw, upcast to f32, card vs CPU
    params = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    host = tree_map(lambda t: t.float().cpu(), first_layers(params, parity_layers))
    del params
    torch.cuda.empty_cache()
    cfg_32 = dataclasses.replace(cfg, n_layers=parity_layers, dtype="float32",
                                 param_dtype="float32")
    grad_parity(dev, "train_qwen3_parity", cfg_32, host,
                {k: v[:, :parity_seq].cpu() for k, v in batch.items()})
    return counts


def dbrx_training(dev, seed=0, layers=1, steps=3, seq=4096, parity_seq=128) -> dict:
    """dbrx-132b at full width, cut to ``layers`` of its 40 layers (bf16;
    AdamW with bf16 moments, the reference's ``state_dtype="bfloat16"``):
    ``steps`` train steps at B = 1, S = ``seq`` (``model_training``; one
    moe_router and one moe_router_bwd a MoE layer).  The depth: one layer
    is 16 x 3 x 6144 x 10752 = 3.17 B expert parameters and ~0.09 B of
    attention, the untied embedding and head 1.23 B, so ~4.49 B in all; a
    step keeps the parameters, gradients, moments and the new trees live
    at once (qwen3 peaks at ~22 B a parameter), so f32 moments (~99 GB)
    do not fit and bf16 moments (~63 GB plus activations) do at one
    layer.  Then ``train_dbrx_parity``: a reduced dbrx (dbrx's 16
    experts, top 4) in f32, the loss and every gradient leaf, the
    router's included, card against CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config("dbrx-132b")
    cfg = dataclasses.replace(full, n_layers=layers)
    counts, _ = model_training(dev, "train_dbrx", cfg, full, text_batch(dev, cfg, 1, seq, seed),
                               steps, [f"{layers} of {full.n_layers} layers", "B=1",
                                       "bf16 AdamW moments", f"{steps} steps on one batch"],
                               opt_dtype="bfloat16", seed=seed)
    red = full.reduced(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_head=32,
                       vocab=4096, moe=dataclasses.replace(full.moe, d_ff_expert=256))
    grad_parity(dev, "train_dbrx_parity", red, M.init_params(red, seed=seed + 1, device="cpu"),
                text_batch("cpu", red, 1, parity_seq, seed + 1), experts=red.moe.n_experts,
                top_k=red.moe.top_k)
    return counts


def kimi_training(dev, seed=0, steps=3, seq=4096, experts=32, parity_seq=128) -> dict:
    """kimi-k2-1t-a32b at full width, cut to its dense prefix layer and one
    MoE layer of ``experts`` of its 384 experts (top 8, the shared expert
    kept): ~4.3 B parameters, bf16, with the int8 AdamW moments the
    reference gives kimi (``launch/dryrun.py``'s ``_opt_cfg``); one layer
    with all 384 experts needs ~68 GB for its weights and gradients alone.
    ``steps`` train steps at B = 1, S = ``seq`` (``model_training``: the
    launches a step checked against ``train_launches``, finite losses);
    then ``train_kimi_parity``: a reduced kimi at head_dim 112, f32, the
    loss and every gradient leaf, card against CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(full, n_layers=2, moe=dataclasses.replace(full.moe, n_experts=experts))
    counts, _ = model_training(dev, "train_kimi", cfg, full, text_batch(dev, cfg, 1, seq, seed),
                               steps, [f"2 of {full.n_layers} layers (the dense prefix and one "
                                       "MoE layer)", f"{experts} of {full.moe.n_experts} experts",
                                       "B=1", "int8 AdamW moments",
                                       f"{steps} steps on one batch"],
                               opt_dtype="int8", seed=seed)
    red = kimi_small(experts, "float32")
    grad_parity(dev, "train_kimi_parity", red, M.init_params(red, seed=seed + 1, device="cpu"),
                text_batch("cpu", red, 1, parity_seq, seed + 1), experts=red.moe.n_experts,
                top_k=red.moe.top_k, head_dim=red.head_dim)
    return counts


# ---------------------------------------------------------------------------
# the mesh over torch.distributed, one rank on the card (NCCL)
# ---------------------------------------------------------------------------
def remat_launches(cfg) -> dict:
    """Launches a meshed train step adds to ``train_launches``: each
    checkpointed period's forward kernels run again in the backward (every
    forward kernel but a dense prefix layer's and the final norm's)."""
    fwd = {k: v[0] for k, v in path_launches(cfg).items()}
    pre = cfg.n_dense_prefix
    return {"flash_attention": fwd["flash_attention"] - pre,
            "rmsnorm": fwd["rmsnorm"] - 1 - pre * (2 + 2 * cfg.qk_norm),
            "moe_router": fwd["moe_router"]}


def mesh_single_rank(dev, seed=0, steps=3) -> dict:
    """A process group of one rank over NCCL (``tcp://localhost`` at a free
    port; NCCL refuses two ranks on one card) and a (1, 1) ("data",
    "model") mesh on it: the wikikv-router's meshed train step
    (``make_train_step(..., mesh=...)``: each layer's leaves gathered on
    use, the periods checkpointed, the gradients arriving as shards, and
    the sharded AdamW of a one-rank mesh) against the unmeshed step, bit
    for bit, over ``steps`` steps, its launches those of the unmeshed step
    and of the recompute (``remat_launches``); ``pipeline_apply`` with one stage
    against the stage, bit for bit; ``restore_elastic`` onto the mesh of
    the meshed run's checkpoint, bit for bit.  The launches of the meshed
    steps are counted."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.manager import CheckpointManager, restore_elastic
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import PipelineSchedule, pipeline_apply
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    # NCCL on the card (gloo where the phase is rehearsed on the CPU)
    on_card = dev.type == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            **({"device_id": torch.device("cuda", dev.index or 0)} if on_card
                               else {}))
    try:
        mesh = make_host_mesh(1, 1)
        cfg = get_config("wikikv-router")
        opt_cfg = AdamWConfig(lr=1e-3)
        batch = text_batch(dev, cfg, 8, 128, seed)
        plain = M.init_params(cfg, seed=seed, device=dev)
        p_opt = adamw_init(plain, opt_cfg)
        step = M.make_train_step(cfg, opt_cfg, total_steps=10)
        meshed = M.shard_params(plain, cfg, mesh)
        m_opt = adamw_init(meshed, opt_cfg, full=M.abstract_params(cfg))
        m_step = M.make_train_step(cfg, opt_cfg, total_steps=10, mesh=mesh)
        losses, m_losses = [], []
        for _ in range(steps):
            plain, p_opt, aux = step(plain, p_opt, batch)
            losses.append(float(aux["loss"]))
        ops.reset_launches()
        for _ in range(steps):
            meshed, m_opt, aux = m_step(meshed, m_opt, batch)
            m_losses.append(float(aux["loss"]))
        counts = dict(ops.LAUNCHES)
        check(m_losses == losses, f"meshed losses {m_losses} != unmeshed {losses}")
        check(all(torch.equal(a, b) for a, b in zip(leaves(meshed), leaves(plain))),
              "the (1, 1) mesh's params differ from the unmeshed step's")
        check(all(torch.equal(a, b) for a, b in zip(leaves(m_opt), leaves(p_opt))),
              "the (1, 1) mesh's AdamW state differs from the unmeshed step's")
        want = {**dict.fromkeys(counts, 0), **{k: steps * v for k, v in train_launches(cfg).items()}}
        for k, v in remat_launches(cfg).items():
            want[k] += steps * v
        check(counts == want, f"meshed step launches {counts} != {want}")

        # the pipeline with one stage over a "pod" axis of one rank
        pmesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("pod", "model"))
        g = torch.Generator(device=dev).manual_seed(seed)
        w = torch.randn((1, 256, 256), generator=g, device=dev) * 0.1
        xs = torch.randn((6, 32, 256), generator=g, device=dev)
        got = pipeline_apply(lambda p, x: torch.tanh(x @ p), w, xs,
                             PipelineSchedule(n_stages=1, n_micro=6), pmesh)
        check(torch.equal(got, torch.stack([torch.tanh(x @ w[0]) for x in xs])),
              "pipeline_apply with one stage differs from the stage")

        # restore_elastic of the meshed run's state onto the mesh
        specs = M.spec_tree(cfg)
        pspecs = {"params": specs, "opt": M.opt_spec_tree(specs, opt_cfg, cfg)}
        with tempfile.TemporaryDirectory() as root:
            mgr = CheckpointManager(root)
            mgr.save(steps, {"params": meshed, "opt": m_opt})
            abstract = M.abstract_params(cfg)
            like = {"params": abstract, "opt": adamw_init(abstract, opt_cfg)}
            at, tree, _ = restore_elastic(mgr, like, mesh, pspecs)
        check(at == steps and all(a.device.type == dev.type and torch.equal(a, b) for a, b in zip(
            leaves(tree), leaves({"params": meshed, "opt": m_opt}))),
            "restore_elastic onto the (1, 1) mesh is not bit for bit")
        remat = remat_policies(dev, cfg, meshed, batch, mesh)
        counts = {k: counts[k] + remat["dots"]["launches"][k] for k in counts}
        emit({"phase": "mesh_single_rank", "backend": dist.get_backend(), "world_size": 1,
              "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "arch": cfg.name,
              "steps": steps, "losses": m_losses, "bit_for_bit": True,
              "pipeline": {"stages": 1, "microbatches": 6, "bit_for_bit": True},
              "restore_elastic": {"leaves": len(leaves(tree)), "bit_for_bit": True},
              "remat_policies": remat, "launches": counts})
        del plain, p_opt, meshed, m_opt, tree
        torch.cuda.empty_cache()
        # the MoE's combine (index_add_) sums a token's expert outputs with
        # float atomics, in any order on the card: under PyTorch's
        # deterministic algorithms it sums them in one order, so the meshed
        # and unmeshed steps can be held to the same bits
        was = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            meshed_counts = meshed_steps(dev, mesh, seed=seed)
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        counts = {k: counts[k] + meshed_counts[k] for k in counts}
        memory_check(dev, mesh, seed=seed)
    finally:
        dist.destroy_process_group()
    return counts


def remat_policies(dev, cfg, params, batch, mesh) -> dict:
    """The meshed train step's loss and gradients (``loss_and_grads`` on
    the mesh, each period checkpointed) under ``REPRO_REMAT_POLICY``
    "nothing" (the default: only the period's input saved) and "dots"
    (the outputs of the products with no batch dimensions saved as well):
    the loss bit for bit and every gradient equal; per policy the kernel
    launches (the attention and the norms are recomputed under both), the
    products run (``aten.mm``/``aten.addmm``: "dots" skips the recompute's)
    and the card's peak memory.  The variable is restored after."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in T._DOTS
            return func(*args, **(kwargs or {}))

    was = os.environ.get("REPRO_REMAT_POLICY")
    runs = {}
    try:
        for policy in ("nothing", "dots"):
            os.environ["REPRO_REMAT_POLICY"] = policy
            check(T.remat_policy() == policy, f"REPRO_REMAT_POLICY={policy} not read")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            with Products() as products:
                loss, grads = M.loss_and_grads(params, batch, cfg, mesh)
            torch.cuda.synchronize()
            runs[policy] = (loss, grads, {"launches": dict(ops.LAUNCHES), "products": products.n,
                                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    finally:
        if was is None:
            os.environ.pop("REPRO_REMAT_POLICY", None)
        else:
            os.environ["REPRO_REMAT_POLICY"] = was
    (l0, g0, a), (l1, g1, b) = runs["nothing"], runs["dots"]
    check(torch.equal(l0, l1), f"remat 'dots' loss {float(l1)} != 'nothing' {float(l0)}")
    check(all(torch.equal(x, y) for x, y in zip(leaves(g0), leaves(g1))),
          "remat 'dots' gradients differ from 'nothing''s")
    check(b["products"] < a["products"], f"remat 'dots' ran {b['products']} products, "
          f"'nothing' {a['products']}")
    check(all(b["launches"][k] <= a["launches"][k] for k in a["launches"]),
          f"remat 'dots' launches {b['launches']} exceed 'nothing''s {a['launches']}")
    print(f"remat policies ({cfg.name} meshed train step): loss bit for bit, gradients equal; "
          f"peak 'nothing' {a['peak_gib']:.4f} GiB, 'dots' {b['peak_gib']:.4f} GiB; products "
          f"{a['products']} / {b['products']}; {nvidia_smi()}", flush=True)
    return {"loss": float(l0), "bit_for_bit": True, "nothing": a, "dots": b}


MESHED_ARCHS = (("wikikv-router", None), ("qwen3-1.7b", None), ("dbrx-132b", 1))
MESHED_KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "moe_router")
#: the meshed decode step at B = 4 on one NCCL rank when each step gathered
#: the whole model (PR 25's tree; NVIDIA H100 80GB HBM3, 700.00 W), ms
PR25_MESHED_DECODE_MS = {"wikikv-router": 16.94, "qwen3-1.7b": 117.53, "dbrx-132b": 50.43}


def meshed_steps(dev, mesh, seed=0, batch=4, seq=4096, dec_steps=16, max_len=512) -> dict:
    """The meshed prefill and serve steps (``make_prefill_step(cfg, mesh)``,
    ``make_serve_step(cfg, mesh)``) on the one-rank mesh against the
    unmeshed steps: the wikikv-router and qwen3-1.7B at full width and
    depth, dbrx-132b at full width cut to 1 of its 40 layers (its prefill
    of B x S tokens through the capacity dispatch), each at B = ``batch``,
    S = ``seq`` and ``dec_steps`` greedy decode steps at B = ``batch``
    from an empty cache (its state cut by ``decode_state_specs``: on one
    rank the whole).  On one rank each layer's gather returns its leaves
    as they are (an axis of one rank moves nothing), so the logits must be
    equal bit for bit and the tokens equal (the caller turns on
    PyTorch's deterministic algorithms: the MoE's ``index_add_`` combine
    is otherwise summed in any order); the launches of the meshed steps
    must equal the unmeshed ones'.  dbrx's expert-parallel
    body (``moe._moe_shard_body``, which a one-wide "model" axis does not
    take, as the reference's ``moe_apply`` does not) is held against the
    local MoE on its layer's input, bit for bit, outside the counts.
    Returns the meshed steps' launch counts."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import shard
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import dp_axes, dp_size
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T
    from repro_torch.tree import map_like
    total = dict.fromkeys(ops.LAUNCHES, 0)
    lines = []
    smi = nvidia_smi()
    for arch, layers in MESHED_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers) if layers else full
        torch.cuda.empty_cache()
        params = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
        shards = M.shard_params(params, cfg, mesh)
        toks = text_batch(dev, cfg, batch, seq, seed)["tokens"]
        runs = {}
        for name, m in (("plain", None), ("meshed", mesh)):
            p = params if m is None else shards
            prefill, serve = M.make_prefill_step(cfg, m), M.make_serve_step(cfg, m)
            state = T.init_decode_state(cfg, batch, max_len, dev)
            if m is not None:
                specs = M.decode_state_specs(cfg, batch, dp=dp_axes(m), dp_size=dp_size(m),
                                             tp_size=1)
                state = map_like(lambda t, s_: shard(t, s_, m), state, specs)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            logits = prefill(p, {"tokens": toks})
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            tok = toks[:, 0].contiguous()
            lengths = torch.zeros(batch, dtype=torch.int32, device=dev)
            out_toks, out_logits = [], []
            t0 = time.perf_counter()
            for _ in range(dec_steps):
                tok, lg, state = serve(p, state, {"tokens": tok, "lengths": lengths})
                out_toks.append(tok)
                out_logits.append(lg)
                lengths = lengths + 1
            torch.cuda.synchronize()
            runs[name] = {"counts": dict(ops.LAUNCHES), "logits": logits, "prefill_ms": prefill_ms,
                          "step_ms": (time.perf_counter() - t0) * 1e3 / dec_steps,
                          "toks": torch.stack(out_toks), "dec_logits": torch.stack(out_logits)}
            del state
        a, b = runs["plain"], runs["meshed"]
        check(torch.equal(a["logits"], b["logits"]),
              f"{arch}: the meshed prefill's logits differ from the unmeshed ones'")
        check(torch.equal(a["toks"], b["toks"]) and torch.equal(a["dec_logits"], b["dec_logits"]),
              f"{arch}: the meshed serve steps differ from the unmeshed ones'")
        check(all(a["counts"][k] == b["counts"][k] for k in MESHED_KERNELS),
              f"{arch}: meshed launches {b['counts']} != unmeshed {a['counts']}")
        for k in MESHED_KERNELS:
            if cfg.moe is not None or k != "moe_router":
                check(b["counts"][k] > 0, f"{arch}: the meshed steps launched no {k}")
        total = {k: total[k] + b["counts"][k] for k in total}
        line = {"arch": arch, "layers": cfg.n_layers, "batch": batch, "seq": seq,
                "dec_steps": dec_steps, "logits_bit_for_bit": True, "tokens_equal": True,
                "launches": {k: b["counts"][k] for k in MESHED_KERNELS},
                "prefill_ms": {n: r["prefill_ms"] for n, r in runs.items()},
                "decode_step_ms": {n: r["step_ms"] for n, r in runs.items()},
                "pr25_meshed_decode_step_ms": PR25_MESHED_DECODE_MS[arch],
                "meshed_decode_below_pr25": b["step_ms"] < PR25_MESHED_DECODE_MS[arch]}
        print(f"meshed_steps {arch} ({cfg.n_layers} layers, B={batch}): decode step unmeshed "
              f"{a['step_ms']:.2f} ms, meshed {b['step_ms']:.2f} ms (whole-model gather, PR 25: "
              f"{PR25_MESHED_DECODE_MS[arch]} ms); prefill S={seq} unmeshed "
              f"{a['prefill_ms']:.2f} ms, meshed {b['prefill_ms']:.2f} ms; {smi}", flush=True)
        if cfg.moe is not None:
            # the expert-parallel body on the one-rank mesh against the local
            # MoE, on 1024 embedded tokens
            with torch.inference_mode():
                h = T.embed_tokens(params, toks[:1, :1024], cfg).reshape(-1, cfg.d_model)
                moe = T._index(params["body"]["slot0"], 0)["moe"]
                local = MoE.moe_apply_local(moe, h, cfg)
                body = MoE._moe_shard_body(h, moe["router"], moe["w_gate"], moe["w_up"],
                                           moe["w_down"], cfg=cfg, mesh=mesh)
            check(torch.equal(local, body), f"{arch}: the expert-parallel body on one rank "
                  "differs from the local MoE")
            line["ep_body_bit_for_bit"] = True
        lines.append(line)
        del params, shards, runs, a, b
    emit({"phase": "meshed_steps", "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "runs": lines, "nvidia_smi": smi})
    return total


HEAD_DIM_RANKS = 2            # "model" ranks of the head_dim decode, threads on the one card
HEAD_DIM_LOGIT_TOL = 1e-4     # of the largest logit: f32 sums over the ranks in another order


def threaded_ranks(dev, tag: str, rank_main, ranks: int = HEAD_DIM_RANKS, timeout: float = 600):
    """``rank_main(rank, mesh)`` for each of ``ranks`` "model" ranks over a
    (1, ranks) ("data", "model") mesh, the ranks threads of this process
    over PyTorch's threaded process group (its collectives are torch ops
    on the card's tensors), all on one stream: the card's default stream,
    which orders the ranks' kernels and the collectives' copies as they
    are issued.  One card cannot hold two NCCL ranks.  Returns {rank:
    what ``rank_main`` returned}; fails if a rank raised or hung."""
    import threading

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed import multi_threaded_pg as mtpg
    got, errors = {}, []

    def run(rank, store):
        try:
            torch.cuda.set_device(dev.index or 0)
            dist.init_process_group("threaded", rank=rank, world_size=ranks, store=store)
            mesh = DeviceMesh(dev.type, torch.arange(ranks).view(1, ranks),
                              mesh_dim_names=("data", "model"))
            got[rank] = rank_main(rank, mesh)
            dist.destroy_process_group()
        except BaseException as exc:          # every rank's failure ends the others
            errors.append(f"rank {rank}: {type(exc).__name__}: {exc}")
            mtpg.ProcessLocalGroup.exception_handle(exc)

    if not hasattr(mtpg.ThreadLocalWorld, "comms"):
        # a distributed_c10d that keeps a list of communicators in its world
        # reads it on every group; this thread's own list
        local = threading.local()
        mtpg.ThreadLocalWorld.comms = property(
            lambda self: local.__dict__.setdefault("comms", []))
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    mtpg._install_threaded_pg()
    try:
        mtpg.ProcessLocalGroup.reset()
        store = dist.HashStore()
        threads = [threading.Thread(target=run, args=(r, store)) for r in range(ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
    finally:
        mtpg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    check(not errors and len(got) == ranks, f"{tag}: {errors or 'hung'}")
    return got


def head_dim_decode(dev, arch="qwen3-1.7b", layers=4, seed=0, batch=4, dec_steps=8,
                    max_len=512) -> dict:
    """The head_dim layout's meshed decode on the card: ``arch`` at full
    width (``layers`` of its layers, f32 weights drawn on the card), its
    decode state cut by ``decode_state_specs(..., cache_layout="head_dim")``
    over a (1, HEAD_DIM_RANKS) ("data", "model") mesh, so each rank holds
    head_dim / HEAD_DIM_RANKS columns of every head and decodes through
    decode_scores, the all-reduce of the partial scores and decode_combine
    (``layers.attn_decode_head_dim``), the embedding and the head
    vocab-parallel.  The ranks are threads of this process
    (``threaded_ranks``).  ``dec_steps`` serve steps
    at B = ``batch`` from an
    empty cache, teacher-forced with the unmeshed steps' tokens: every
    rank's logits within HEAD_DIM_LOGIT_TOL of the largest of the
    unmeshed ones, the greedy tokens equal but at near ties, each rank's
    cache block equal to that block of the unmeshed cache.  The counts
    are set to 0 just before the meshed steps and read just after: one
    decode_scores and one decode_combine a layer a step a rank, and no
    decode_attention.  Returns those counts."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import shard
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import dp_axes, dp_size
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, map_like
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32",
                              param_dtype="float32")
    torch.cuda.empty_cache()
    params = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    toks = text_batch(dev, cfg, batch, dec_steps, seed)["tokens"]
    serve = M.make_serve_step(cfg)
    state = T.init_decode_state(cfg, batch, max_len, dev)
    want, lengths = [], torch.zeros(batch, dtype=torch.int32, device=dev)
    for i in range(dec_steps):
        _, lg, state = serve(params, state, {"tokens": toks[:, i].contiguous(),
                                             "lengths": lengths})
        want.append(lg)
        lengths = lengths + 1
    torch.cuda.synchronize()
    ms = {}

    def rank_main(rank, mesh):
        shards = M.shard_params(params, cfg, mesh)
        specs = M.decode_state_specs(cfg, batch, dp=dp_axes(mesh), dp_size=dp_size(mesh),
                                     cache_layout="head_dim", tp_size=HEAD_DIM_RANKS)
        st = map_like(lambda t, s_: shard(t, s_, mesh),
                      T.init_decode_state(cfg, batch, max_len, dev), specs)
        step = M.make_serve_step(cfg, mesh, cache_layout="head_dim")
        ln, out = torch.zeros(batch, dtype=torch.int32, device=dev), []
        dist.barrier()
        t0 = time.perf_counter()
        for i in range(dec_steps):
            _, lg, st = step(shards, st, {"tokens": toks[:, i].contiguous(), "lengths": ln})
            out.append(lg)
            ln = ln + 1
        torch.cuda.synchronize()
        ms[rank] = (time.perf_counter() - t0) * 1e3 / dec_steps
        blocks = map_like(lambda t, s_: shard(t, s_, mesh), state, specs)
        return torch.stack(out), leaves(st), leaves(blocks)

    # decode_combine's split workspace made before the ranks share it
    Dl = cfg.head_dim // HEAD_DIM_RANKS
    ops.decode_combine(torch.zeros((batch, cfg.n_heads, max_len), device=dev),
                       torch.zeros((batch, cfg.n_kv_heads, max_len, Dl), device=dev),
                       torch.ones(batch, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    ops.reset_launches()
    got = threaded_ranks(dev, "head_dim decode", rank_main)
    counts = dict(ops.LAUNCHES)
    want = torch.stack(want)[..., :cfg.vocab]        # the padded ids are -inf in both
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * HEAD_DIM_LOGIT_TOL * float(want.abs().max())
    line = {"phase": "head_dim_decode", "arch": arch, "layers": layers, "dtype": "float32",
            "ranks": HEAD_DIM_RANKS, "batch": batch, "dec_steps": dec_steps, "max_len": max_len,
            "process_group": "threaded (threads on one card)", "decode_step_ms": ms}
    for rank, (lg, st, blocks) in got.items():
        lg = lg[..., :cfg.vocab]
        err = float((lg - want).abs().max()) / float(want.abs().max())
        check(err <= HEAD_DIM_LOGIT_TOL, f"head_dim decode rank {rank}: logits {err} of the "
              f"largest from the unmeshed ones (tolerance {HEAD_DIM_LOGIT_TOL})")
        same = lg.argmax(-1) == want.argmax(-1)
        check(bool(same[sure].all()), f"head_dim decode rank {rank}: a greedy token differs "
              "away from a near tie")
        cache_err = max(float((a - b).abs().max()) for a, b in zip(st, blocks))
        check(cache_err <= 1e-5 * max(float(b.abs().max()) for b in blocks),
              f"head_dim decode rank {rank}: its cache block differs from the unmeshed cache's "
              f"({cache_err})")
        line[f"rank{rank}"] = {"logit_err_share": err, "tokens_equal": int(same.sum()),
                               "tokens": same.numel(), "near_ties": int((~sure).sum()),
                               "cache_block_max_abs_err": cache_err}
    n = layers * dec_steps * HEAD_DIM_RANKS
    check(counts["decode_scores"] == n and counts["decode_combine"] == n
          and counts["decode_attention"] == 0,
          f"head_dim decode launches {counts}: not {n} decode_scores and decode_combine")
    line["launches"] = counts
    line["nvidia_smi"] = nvidia_smi()
    emit(line)
    del params, state
    torch.cuda.empty_cache()
    return counts


#: the recurrent families of the tensor-parallel phase: (arch, layers, experts
#: kept or None) — jamba's one period with 2 of its 16 experts, as
#: ``jamba_training`` cuts it, and xlstm's one period
RECURRENT_TP = (("jamba-v0.1-52b", 8, 2), ("xlstm-350m", 8, None))
STATE_TOL = 1e-5              # of a state block's largest value
WITNESS_FACTOR = 2            # a bound of twice the unmeshed step's own rounding witness


def recurrent_tp(dev, seed=0, batch=4, seq=512, dec_steps=8, max_len=64) -> dict:
    """The recurrent blocks tensor-parallel over "model" on the card: each
    of RECURRENT_TP at full width (f32 weights drawn on the card), over
    HEAD_DIM_RANKS "model" ranks as threads of this process
    (``threaded_ranks``), after a check that the threaded group's
    all-to-all (the channel take's exchange) moves uneven blocks.  Per
    arch the meshed prefill step at B = ``batch``, S = ``seq``, then
    ``dec_steps`` meshed serve steps from an empty state, teacher-forced
    with the unmeshed steps' tokens.  Every rank's logits are held within
    HEAD_DIM_LOGIT_TOL of the largest unmeshed logit and each rank's block
    of every recurrent state within STATE_TOL of that block's largest,
    or within WITNESS_FACTOR times the unmeshed steps' own witness where
    that is larger: how far the unmeshed steps move when the embedding is
    perturbed by 1e-7 (xlstm's layers amplify a rounding difference; the
    ranks sum in another order).  The greedy tokens are equal but at near
    ties, the mLSTM states equal on both ranks bit for bit, and no
    ``sharding.gather`` call takes a recurrent state.  The counts are set
    to 0 just before the meshed steps and read just after; they must be
    the ranks' ``path_launches``, exactly.  Then, outside the counts, the
    first recurrent layer of each kind (mamba with its MLP and with its
    MoE, the mLSTM, the sLSTM) alone on one random input of B x S, meshed
    (``transformer._layer`` on the rank's shards and sequence shard)
    against unmeshed, within HEAD_DIM_LOGIT_TOL of the largest output:
    a layer's own rounding, which xlstm's depth amplifies end to end.
    Returns the counts, summed."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import dp_axes, dp_size
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import map_like
    total = {}
    smi = nvidia_smi()
    state_ptrs, hits = set(), []
    real_gather = SH.gather

    def watched_gather(t, spec, mesh, axes=None):
        if t.untyped_storage().data_ptr() in state_ptrs:
            hits.append(tuple(t.shape))
        return real_gather(t, spec, mesh, axes)

    def uneven_exchange(rank, mesh):
        # rank r sends r + 1 rows to each rank; each receives s + 1 from rank s
        n = HEAD_DIM_RANKS
        out = torch.empty(n * (n + 1) // 2, device=dev)
        dist.all_to_all_single(out, torch.full((n * (rank + 1),), float(rank), device=dev),
                               output_split_sizes=[s + 1 for s in range(n)],
                               input_split_sizes=[rank + 1] * n, group=mesh.get_group("model"))
        want = torch.cat([torch.full((s + 1,), float(s), device=dev) for s in range(n)])
        return bool(torch.equal(out, want))

    check(all(threaded_ranks(dev, "threaded all-to-all", uneven_exchange).values()),
          "the threaded group's all_to_all_single moved the wrong rows")

    def share(a, b) -> float:
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    for arch, layers, experts in RECURRENT_TP:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers, dtype="float32", param_dtype="float32")
        if experts:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=experts))
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = T.init_params(gen, cfg)
        toks = text_batch(dev, cfg, batch, seq, seed)["tokens"]
        prefill, serve = M.make_prefill_step(cfg), M.make_serve_step(cfg)
        kinds = {f"slot{i}": k for i, k in enumerate(cfg.block_pattern) if k in T.RECURRENT_KINDS}

        def unmeshed(p, inputs=None):
            """(prefill logits, serve logits, final state, the serve steps' input
            tokens, ms): the unmeshed steps, fed ``inputs`` or their own greedy
            tokens."""
            st = T.init_decode_state(cfg, batch, max_len, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre = prefill(p, {"tokens": toks})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ins, out = [toks[:, 0].contiguous()], []
            ln = torch.zeros(batch, dtype=torch.int32, device=dev)
            for i in range(dec_steps):
                nt, lg, st = serve(p, st, {"tokens": (inputs or ins)[i], "lengths": ln})
                out.append(lg)
                ins.append(nt)
                ln = ln + 1
            torch.cuda.synchronize()
            ms = {"prefill": (t1 - t0) * 1e3,
                  "serve_step": (time.perf_counter() - t1) * 1e3 / dec_steps}
            return pre, torch.stack(out)[..., :cfg.vocab], st, inputs or ins, ms

        want_pre, want, state, inputs, plain_ms = unmeshed(params)
        # the witness: the same steps with the embedding moved by 1e-7
        moved = dict(params, embed=params["embed"] * (1 + 1e-7 * torch.randn(
            params["embed"].shape, generator=gen, device=dev)))
        w_pre, w_lg, w_st = unmeshed(moved, inputs)[:3]
        del moved
        witness = {"prefill": share(w_pre, want_pre), "serve": share(w_lg, want),
                   "state": {f"{slot}[{i}]": share(a, b) for slot in kinds
                             for i, (a, b) in enumerate(zip(w_st[slot], state[slot]))}}
        del w_pre, w_lg, w_st
        ms = {}

        def rank_main(rank, mesh):
            shards = M.shard_params(params, cfg, mesh)
            specs = M.decode_state_specs(cfg, batch, dp=dp_axes(mesh), dp_size=dp_size(mesh),
                                         cache_layout="auto", tp_size=HEAD_DIM_RANKS)
            st = map_like(lambda t, s_: SH.shard(t, s_, mesh),
                          T.init_decode_state(cfg, batch, max_len, dev), specs)
            state_ptrs.update(t.untyped_storage().data_ptr() for slot in kinds for t in st[slot])
            step = M.make_serve_step(cfg, mesh)
            ln, out = torch.zeros(batch, dtype=torch.int32, device=dev), []
            dist.barrier()
            t0 = time.perf_counter()
            pre = M.make_prefill_step(cfg, mesh)(shards, {"tokens": toks})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(dec_steps):
                _, lg, st = step(shards, st, {"tokens": inputs[i], "lengths": ln})
                out.append(lg)
                ln = ln + 1
            torch.cuda.synchronize()
            ms[rank] = {"prefill": (t1 - t0) * 1e3,
                        "serve_step": (time.perf_counter() - t1) * 1e3 / dec_steps}
            blocks = {slot: [SH.shard(t, s_, mesh) for t, s_ in zip(state[slot], specs[slot])]
                      for slot in kinds}
            return pre, torch.stack(out), {slot: list(st[slot]) for slot in kinds}, blocks

        torch.cuda.synchronize()
        ops.reset_launches()
        SH.gather = watched_gather
        try:
            got = threaded_ranks(dev, f"recurrent_tp {arch}", rank_main)
        finally:
            SH.gather = real_gather
        counts = dict(ops.LAUNCHES)
        state_ptrs.clear()
        tol = {k: max(HEAD_DIM_LOGIT_TOL, WITNESS_FACTOR * witness[k])
               for k in ("prefill", "serve")}
        top2 = want.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * tol["serve"] * float(want.abs().max())
        line = {"phase": "recurrent_tp", "arch": arch, "layers": layers,
                "of_layers": full.n_layers, "experts": experts, "dtype": "float32",
                "ranks": HEAD_DIM_RANKS, "batch": batch, "seq": seq, "dec_steps": dec_steps,
                "process_group": "threaded (threads on one card)", "unmeshed_ms": plain_ms,
                "meshed_ms": ms, "witness": witness, "logit_tol": tol}
        check(not hits, f"recurrent_tp {arch}: sharding.gather took a recurrent state {hits}")
        for rank, (pre, lg, st, blocks) in got.items():
            lg = lg[..., :cfg.vocab]
            err = {"prefill": share(pre, want_pre), "serve": share(lg, want)}
            for k, e in err.items():
                check(e <= tol[k], f"recurrent_tp {arch} rank {rank}: {k} logits {e} of the "
                      f"largest from the unmeshed ones (tolerance {tol[k]})")
            same = lg.argmax(-1) == want.argmax(-1)
            check(bool(same[sure].all()), f"recurrent_tp {arch} rank {rank}: a greedy token "
                  "differs away from a near tie")
            state_err = {}
            for slot, kind in kinds.items():
                for i, (a, b) in enumerate(zip(st[slot], blocks[slot])):
                    key = f"{slot}[{i}]"
                    state_err[key] = e = share(a, b)
                    bound = max(STATE_TOL, WITNESS_FACTOR * witness["state"][key])
                    check(e <= bound, f"recurrent_tp {arch} rank {rank}: {kind} state {key} "
                          f"{e} of its largest from the unmeshed block's (tolerance {bound})")
                    if kind == "mlstm":
                        check(torch.equal(a, got[0][2][slot][i]), f"recurrent_tp {arch}: "
                              f"rank {rank}'s mLSTM state {key} differs from rank 0's")
            line[f"rank{rank}"] = {"logit_err_share": err, "tokens_equal": int(same.sum()),
                                   "tokens": same.numel(), "near_ties": int((~sure).sum()),
                                   "state_block_err_share_max": max(state_err.values()),
                                   "state_block_err_share": state_err}
        pl = path_launches(cfg)
        need = {k: HEAD_DIM_RANKS * (pl[k][0] + dec_steps * pl[k][1]) for k in MESHED_KERNELS}
        check(all(counts[k] == n for k, n in need.items())
              and counts["decode_scores"] == counts["decode_combine"] == 0,
              f"recurrent_tp {arch} launches {counts}, not {need}")
        line["launches"] = {k: counts[k] for k in MESHED_KERNELS}
        # each kind's first layer alone, meshed against unmeshed, on one input
        del got
        xin = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev)
        firsts = {}
        for slot, kind in kinds.items():
            firsts.setdefault((kind, "moe" in params["body"][slot]), slot)
        with torch.inference_mode():
            want_layer = {slot: T._slot_apply(kinds[slot], T._index(params["body"][slot], 0), xin,
                                              cfg) for slot in firsts.values()}

        def layer_main(rank, mesh):
            part = T.partition(mesh, batch, M.spec_tree(cfg)).with_seq(seq)
            out = {}
            for slot in firsts.values():
                specs = T._layer_specs(part.specs["body"][slot], True)
                local = map_like(lambda t, s_: SH.shard(t, s_, mesh),
                                 T._index(params["body"][slot], 0), specs)
                with torch.inference_mode():
                    out[slot] = T._layer(kinds[slot], local, specs, part.local_seq(xin), cfg, part)
            return out, part.rank * (seq // part.tp) if part.seq else 0

        layer_err = {}
        for rank, (out, lo) in threaded_ranks(dev, f"recurrent_tp {arch} layers",
                                              layer_main).items():
            for slot, y in out.items():
                want_y = want_layer[slot][:, lo:lo + y.shape[1]]
                layer_err[f"rank{rank} {slot} {kinds[slot]}"] = e = share(y, want_y)
                check(e <= HEAD_DIM_LOGIT_TOL, f"recurrent_tp {arch} rank {rank}: layer {slot} "
                      f"({kinds[slot]}) {e} of the largest output from the unmeshed layer's")
        line["layer_err_share"] = layer_err
        line["nvidia_smi"] = smi
        emit(line)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        del params, state, want_pre, want, want_layer
        torch.cuda.empty_cache()
    return total


MEMORY_BAND = (0.85, 1.15)   # the dry run's predicted bytes over the card's peak


def memory_check(dev, mesh, seed=0, seq=4096) -> None:
    """The dry run's per-card memory against the card: qwen3-1.7B's meshed
    train step (each layer gathered on use, its periods checkpointed) at
    B = 1, S = ``seq`` traced on a one-rank fake mesh (in a
    child process: the fake group cannot share this process with the NCCL
    one), then the same step run on the one-rank NCCL mesh.  The predicted
    ``total_per_device`` over ``torch.cuda.max_memory_allocated()`` (from
    what was allocated before the arguments) must lie in MEMORY_BAND; the
    predicted FLOPs are printed beside ``model_flops``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _opt_cfg
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    code = ("import json, sys\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.launch.mesh import make_host_mesh\n"
            "from repro_torch.models import model as M\n"
            "dryrun.start_fake_group(1)\n"
            f"r = dryrun.trace_cell(get_config('qwen3-1.7b'), M.ShapeSpec('train', {seq}, 1, "
            "'train'), make_host_mesh(1, 1), 'cuda')\n"
            "print(json.dumps({k: r[k] for k in ('memory', 'cost', 'collectives', 'trace_s')}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=str(SRC)))
    check(proc.returncode == 0, f"the one-rank dry-run trace failed:\n{proc.stderr[-3000:]}")
    pred = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg = get_config("qwen3-1.7b")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = M.shard_params(T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg),
                            cfg, mesh)
    torch.cuda.empty_cache()
    opt_cfg = _opt_cfg(cfg)
    opt = adamw_init(params, opt_cfg, full=M.abstract_params(cfg))
    batch = text_batch(dev, cfg, 1, seq, seed)
    step = M.make_train_step(cfg, opt_cfg, mesh=mesh)
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    _, _, aux = step(params, opt, batch)
    loss = float(aux["loss"])
    measured = torch.cuda.max_memory_allocated() - base
    predicted = pred["memory"]["total_per_device"]
    ratio = predicted / measured
    mf = M.model_flops(cfg, M.ShapeSpec("train", seq, 1, "train"))
    line = {"phase": "dryrun_memory", "arch": cfg.name, "batch": 1, "seq": seq, "mesh": "1x1",
            "remat": "each period checkpointed", "loss": loss, "predicted_total_per_device": predicted,
            "predicted_argument_bytes": pred["memory"]["argument_size_in_bytes"],
            "measured_argument_bytes": args, "measured_max_allocated": measured,
            "predicted_over_measured": ratio, "predicted_flops": pred["cost"]["flops"],
            "model_flops": mf, "model_flops_over_predicted": mf / pred["cost"]["flops"],
            "trace_s": pred["trace_s"],
            "nvidia_smi": nvidia_smi()}
    emit(line)
    print(f"dry-run memory of qwen3-1.7b's one-rank train step (B=1, S={seq}): predicted "
          f"{predicted / 2**30:.3f} GiB, card {measured / 2**30:.3f} GiB (ratio {ratio:.4f}); "
          f"predicted FLOPs {pred['cost']['flops'] / 1e12:.3f} T against model_flops "
          f"{mf / 1e12:.3f} T", flush=True)
    check(math.isfinite(loss), f"qwen3 one-rank meshed train step: loss {loss}")
    check(MEMORY_BAND[0] <= ratio <= MEMORY_BAND[1],
          f"predicted memory {predicted} over the card's {measured} = {ratio:.4f}, outside "
          f"{MEMORY_BAND}")
    del params, opt, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the dry run over a fake process group of 256 / 512 ranks
# ---------------------------------------------------------------------------
#: one arch a family at train_4k and decode_32k on 16x16 (jamba's and
#: xlstm's train_4k trace their per-step scan loops op by op for minutes:
#: they run in the --all sweep), kimi-k2's train_4k on 2x16x16
DRYRUN_CELLS = [(a, s, "single") for a in ("qwen3-1.7b", "dbrx-132b", "whisper-medium",
                                           "internvl2-1b") for s in ("train_4k", "decode_32k")]
DRYRUN_CELLS += [("jamba-v0.1-52b", "decode_32k", "single"), ("xlstm-350m", "decode_32k", "single"),
                 ("kimi-k2-1t-a32b", "train_4k", "multi"),
                 ("codeqwen1.5-7b", "train_4k", "single"), ("codeqwen1.5-7b", "decode_32k", "single"),
                 ("olmo-1b", "decode_32k", "single")]
#: the partitioned steps' predictions on 16x16 (each layer gathered on use,
#: tensor-parallel attention and MLP, the KV-head-sharded cache): per cell
#: the largest ``total_per_device`` (GiB), the least ``useful_flops_ratio``
#: and the most collective bytes a step (a tenth of the whole-model
#: gather's, PR 25's dry run)
DRYRUN_LIMITS = {("qwen3-1.7b", "train_4k"): {"gib": 80.0, "useful": 0.25},
                 ("codeqwen1.5-7b", "train_4k"): {"gib": 80.0},
                 ("codeqwen1.5-7b", "decode_32k"): {"collective": 154.75e9 / 10},
                 ("olmo-1b", "decode_32k"): {"collective": 36.85e9 / 10},
                 ("whisper-medium", "decode_32k"): {"collective": 27.80e9 / 10},
                 # the head_dim layout's decode, against the 3.17e10 and 6.88e10
                 # bytes a step of each layer's cache gathered over "model" (nearly
                 # all of qwen3's): qwen3 a fifth; dbrx a third, since its experts'
                 # gathers over "data" alone move ~1.6e10 a step
                 ("qwen3-1.7b", "decode_32k"): {"collective": 3.17e10 / 5},
                 ("dbrx-132b", "decode_32k"): {"collective": 6.88e10 / 3},
                 # the recurrent blocks tensor-parallel over "model", against the
                 # 1.637e10 and 9.05e8 bytes a step and the 1466083328 and 854783264
                 # bytes a card of the dry run that gathered each mamba, mLSTM and
                 # sLSTM layer's leaves whole: jamba's experts' gathers over "data"
                 # keep ~5.6e9 of its bytes
                 ("jamba-v0.1-52b", "decode_32k"): {"collective": 8.0e9,
                                                    "gib": 1466083328 / 2**30},
                 ("xlstm-350m", "decode_32k"): {"collective": 2.3e8, "gib": 854783264 / 2**30}}
#: cells traced on fake "cpu" too, whose counts must equal the fake-"cuda" trace's
DRYRUN_BOTH = [("dbrx-132b", "train_4k", "single"), ("qwen3-1.7b", "decode_32k", "single")]
DRYRUN_WORKERS = 8


def dryrun_phase() -> None:
    """``python -m repro_torch.launch.dryrun`` over DRYRUN_CELLS on fake
    "cuda" (the kernels' shape rules), each cell in a process of its own,
    DRYRUN_WORKERS at a time, and DRYRUN_BOTH on fake "cpu" (the plain
    versions) too: every cell ``ok``, one line each (status, dominant
    term, the three times, the per-card GiB, the useful share of the
    FLOPs), and equal ``cost``, ``collectives`` and ``memory`` on the two
    devices, and each DRYRUN_LIMITS cell within its limits.  The times
    are predictions from an H100 SXM's published rates, not
    measurements."""
    root = Path(tempfile.mkdtemp(prefix="dryrun-"))
    jobs = [(c, "cuda") for c in DRYRUN_CELLS] + [(c, "cpu") for c in DRYRUN_BOTH]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    results, running = {}, []
    # a job is ((arch, shape, mesh), device); a cell traced on both devices
    # is two jobs
    try:
        while jobs or running:
            while jobs and len(running) < DRYRUN_WORKERS:
                (arch, shape, mesh), device = job = jobs.pop(0)
                out = root / device
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape, "--mesh", mesh, "--device", device, "--out-dir", str(out)]
                running.append((job, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True),
                                time.perf_counter()))
            job, proc, t_start = running.pop(0)
            log = proc.communicate(timeout=900)[0]
            (arch, shape, mesh), device = job
            name = f"{arch}__{shape}__{'2x16x16' if mesh == 'multi' else '16x16'}.json"
            check(proc.returncode == 0, f"dryrun {arch} {shape} {mesh} {device}: exit "
                  f"{proc.returncode}\n{log[-3000:]}")
            results[job] = json.loads((root / device / name).read_text())
            results[job]["wall_s"] = time.perf_counter() - t_start
    finally:
        for _, proc, _ in running:
            proc.kill()
        shutil.rmtree(root, ignore_errors=True)
    cells = []
    for job, res in results.items():
        (arch, shape, mesh), device = job
        check(res["status"] == "ok", f"dryrun {job}: {res.get('error')}")
        r = res["roofline"]
        print(f"dryrun [{res['status']}] {arch:16s} {shape:11s} {res['mesh']:8s} {device:4s} "
              f"dom={r['dominant']:10s} tc={r['t_compute_s']:.4e} tm={r['t_memory_s']:.4e} "
              f"tx={r['t_collective_s']:.4e} "
              f"mem={res['memory']['total_per_device'] / 2**30:.2f}GiB "
              f"useful={r['useful_flops_ratio']:.5f} trace={res['trace_s']:.1f}s", flush=True)
        cells.append({"arch": arch, "shape": shape, "mesh": res["mesh"], "device": device,
                      "status": res["status"], "dominant": r["dominant"],
                      "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
                      "t_collective_s": r["t_collective_s"],
                      "total_per_device_gib": res["memory"]["total_per_device"] / 2**30,
                      "useful_flops_ratio": r["useful_flops_ratio"],
                      "collective_bytes": res["collectives"]["total_bytes"],
                      "trace_s": res["trace_s"], "wall_s": res["wall_s"]})
        lim = DRYRUN_LIMITS.get((arch, shape)) if mesh == "single" and device == "cuda" else None
        if lim:
            gib = res["memory"]["total_per_device"] / 2**30
            moved = res["collectives"]["total_bytes"]
            print(f"dryrun limits {arch} {shape} 16x16: total_per_device {gib:.3f} GiB "
                  f"(< {lim.get('gib')}), useful_flops_ratio {r['useful_flops_ratio']:.5f} "
                  f"(>= {lim.get('useful')}), collective bytes {moved:.6e} "
                  f"(<= {lim.get('collective')})", flush=True)
            check(gib < lim.get("gib", math.inf), f"dryrun {arch} {shape}: {gib} GiB a card")
            check(r["useful_flops_ratio"] >= lim.get("useful", 0.0),
                  f"dryrun {arch} {shape}: useful_flops_ratio {r['useful_flops_ratio']}")
            check(moved <= lim.get("collective", math.inf),
                  f"dryrun {arch} {shape}: {moved} collective bytes a step")
    check({(a, s) for a, s, m in DRYRUN_CELLS if m == "single"} >= set(DRYRUN_LIMITS),
          "a DRYRUN_LIMITS cell is not traced")
    for cell in DRYRUN_BOTH:
        a, b = results[(cell, "cuda")], results[(cell, "cpu")]
        for key in ("cost", "collectives", "memory"):
            check(a[key] == b[key], f"dryrun {cell}: {key} on fake cuda {a[key]} != fake cpu "
                  f"{b[key]}")
    emit({"phase": "dryrun", "predictions_from": "H100 SXM published rates (dryrun.PEAK_FLOPS, "
          "HBM_BW, NET_BW)", "cells": cells,
          "cuda_equals_cpu": [list(c) for c in DRYRUN_BOTH],
          "wall_s": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})


# ---------------------------------------------------------------------------
# the training of the SSM, xLSTM, encoder-decoder and vision families
# ---------------------------------------------------------------------------
def train_launches(cfg) -> dict:
    """Launches of each kernel in one train step: one forward and one
    backward kernel a forward call of flash_attention, rmsnorm and
    moe_router (``encdec_launches`` or ``path_launches`` count those)."""
    fwd = (encdec_launches(cfg)[0] if cfg.is_encdec
           else {k: v[0] for k, v in path_launches(cfg).items()})
    return {f"{k}{bwd}": fwd.get(k, 0) for k in ("flash_attention", "rmsnorm", "moe_router")
            for bwd in ("", "_bwd")}


def block_times(dev, cfg, params, x, kinds) -> dict:
    """Where a recurrent train step's time goes: for each block kind of
    ``kinds``, its first layer alone at the step's input shape ``x``
    (B, S, D), the forward under grad (the scan's) and the backward
    (``torch.autograd.grad`` of every weight and the input), each on the
    host's clock between synchronisations (the loops are host-bound), the
    faster of two calls right after the train steps."""
    import torch
    from repro_torch.models import transformer as T
    out = {}
    for kind in kinds:
        slot = cfg.block_pattern.index(kind)
        name, _, apply = T._BLOCKS[kind][:3]
        p = {k: v.detach().requires_grad_(True)
             for k, v in T._index(params["body"][f"slot{slot}"], 0)[name].items()}
        xi = x.detach().requires_grad_(True)
        wrt = [xi] + list(p.values())
        fwd, bwd = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.enable_grad():
                y = apply(p, xi, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = torch.autograd.grad(y, wrt, torch.ones_like(y))
            torch.cuda.synchronize()
            fwd.append((t1 - t0) * 1e3)
            bwd.append((time.perf_counter() - t1) * 1e3)
            del y, grads
        out[kind] = {"forward_ms": min(fwd), "backward_ms": min(bwd),
                     "layers_a_step": (list(cfg.block_pattern) * cfg.n_periods).count(kind)}
    return out


def model_training(dev, tag, cfg, full, batch, steps, cuts, opt_dtype="float32", seed=0,
                   blocks=()) -> tuple[dict, dict]:
    """``cfg`` (``full`` cut as ``cuts`` lists) trained on the card: weights
    drawn on the card from ``seed``, AdamW with ``opt_dtype`` moments,
    ``steps`` make_train_step steps on one fixed ``batch`` (on the card),
    the launches counted and checked per step against ``train_launches``,
    finite losses, step ms (the median after the first) with its device
    split, tokens/s, peak memory and the eager AdamW update alone (on
    random gradients of the parameters' shapes); with ``blocks`` the
    forward and backward of one layer of each kind (``block_times``).
    Returns the launch counts and the emitted line."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    n_params = sum(t.numel() for t in leaves(params))
    opt_cfg = AdamWConfig(lr=3e-4, state_dtype=opt_dtype)
    opt = adamw_init(params, opt_cfg)
    step = M.make_train_step(cfg, opt_cfg, total_steps=steps)

    # the main path: counts from zero, `steps` train steps, read just after
    ops.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, aux = step(params, opt, batch)
        losses.append(float(aux["loss"]))
        times.append(time.perf_counter() - t0)
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite losses {losses}")
    per_step = {k: v / steps for k, v in counts.items()}
    want = {**dict.fromkeys(counts, 0), **train_launches(cfg)}
    check(per_step == want, f"{tag}: launches a step {per_step} != {want}")
    step_ms = statistics.median(times[1:]) * 1e3
    block_ms = None
    if blocks:
        x = torch.randn((batch["tokens"].shape[0], batch["tokens"].shape[1], cfg.d_model),
                        generator=torch.Generator(device=dev).manual_seed(seed + 1),
                        device=dev).to(getattr(torch, cfg.dtype))
        block_ms = block_times(dev, cfg, params, x, blocks)
        del x
    split = device_split(lambda: step(params, opt, batch), step_ms)
    # the update's time does not depend on the gradients' values
    grads = tree_map(torch.randn_like, params)
    opt_ms = cuda_ms(lambda: adamw_update(params, grads, opt, opt_cfg), iters=2, warmup=1)
    del grads
    n_tok = batch["tokens"].numel()
    line = {"phase": tag, "arch": cfg.name, "layers": cfg.n_layers, "of": full.n_layers,
            "enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model, "reduced": cuts,
            "batch": {k: list(v.shape) for k, v in batch.items()}, "params": n_params,
            "param_dtype": cfg.param_dtype, "moments": opt_dtype, "steps": steps,
            "losses": losses, "step_ms": step_ms, "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": n_tok / step_ms * 1e3, "peak_gib": peak,
            "launches_per_step": per_step, "step_split": split, "adamw_ms": opt_ms}
    if block_ms is not None:
        line["block_ms"] = block_ms
    line["nvidia_smi"] = nvidia_smi()
    emit(line)
    del params, opt, aux
    torch.cuda.empty_cache()
    return counts, line


def grad_parity(dev, tag, cfg, host, batch, witness_draws=0, **extra) -> dict:
    """f32 parity of a train step's loss and every gradient leaf, card
    against CPU (the same weights ``host`` and ``batch``), with router near
    ties reported through ``first_flip`` (their gradients then differ by
    design and are not compared).  The gradients are held within 1e-4 of
    each leaf's largest; with ``witness_draws`` (xlstm, whose random layers
    amplify rounding) within twice the card's own witness where that is
    larger: the largest change of the card's gradients, relative to each
    leaf's largest, under that many 1e-7 perturbations of the embedding
    table.  Emits and returns the parity line."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import leaves
    card_p = M._to(host, dev)
    on_card = {k: v.to(dev) for k, v in batch.items()}
    (loss_c, grads_c), log_c = logged_run(lambda: M.loss_and_grads(card_p, on_card, cfg))
    grads_c = [g.cpu() for g in leaves(grads_c)]
    (loss_h, grads_h), log_h = logged_run(lambda: M.loss_and_grads(host, batch, cfg))
    grads_h = leaves(grads_h)

    def rel(gc, gh):
        return float((gc - gh).abs().max()) / max(float(gh.abs().max()), 1e-30)
    tol = 1e-4
    par = {"phase": tag, "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": {k: list(v.shape) for k, v in batch.items()}, **extra,
           "loss_card": float(loss_c), "loss_cpu": float(loss_h),
           "loss_rel_diff": abs(float(loss_c) - float(loss_h)) / abs(float(loss_h)),
           "grad_leaves": len(grads_h), "router_near_tie": None}
    if cfg.moe is not None:
        par["router_near_tie"] = first_flip(log_h, log_c, cfg.moe.top_k)
    if witness_draws:
        witness = 0.0
        for i in range(witness_draws):
            noise = torch.from_numpy(np.random.RandomState(100 + i).randn(
                *host["embed"].shape).astype(np.float32)).to(dev)
            moved = dict(card_p, embed=card_p["embed"] * (1 + 1e-7 * noise))
            _, g = M.loss_and_grads(moved, on_card, cfg)
            witness = max(witness, max(rel(a.cpu(), b) for a, b in zip(leaves(g), grads_c)))
        check(witness <= 1e-2, f"{tag}: the card's own witness {witness} > 1e-2")
        par["witness_grad_rel_1e-7"] = witness
        tol = max(tol, 2 * witness)
    par["tolerance"] = {"loss_rel": 3e-5, "grad_rel_to_leaf_max": tol}
    if par["router_near_tie"] is None:
        par["worst_grad_diff_rel_to_leaf_max"] = max(rel(a, b) for a, b in zip(grads_c, grads_h))
        check(par["loss_rel_diff"] <= 3e-5 and par["worst_grad_diff_rel_to_leaf_max"] <= tol,
              f"{tag} f32 gradients, card vs CPU: {par}")
    emit(par)
    del card_p, on_card, grads_c
    torch.cuda.empty_cache()
    return par


def text_batch(dev, cfg, B, S, seed, **extra) -> dict:
    """Random tokens and their next-token labels (B, S) on ``dev``, with
    ``extra`` tensors (frames, prefix embeddings) moved there too."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev),
            **{k: v.to(dev) for k, v in extra.items()}}


def xlstm_training(dev, seed=0, steps=2, seq=2048, layers=8, parity_seq=64) -> dict:
    """xlstm-350m at full width cut to ``layers`` of its 24 layers (bf16,
    f32 AdamW moments; cut from 24 to keep the smoke inside its time
    limit), B = 1, S = ``seq``: its train steps (``model_training``),
    with one sLSTM and one mLSTM layer's forward and backward timed alone.
    S is cut from 4096 to 2048 because a step at 4096 took 14.3–16.6 s on
    an H100 (host-bound: the sLSTM loop's forward under grad and its
    autograd backward, ~20 and ~40 launches a time step);
    then ``train_xlstm_parity``: the reduced xlstm (16 layers) in f32 at
    B = 2, S = ``parity_seq``, card against CPU, within twice the card's
    own witness."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config("xlstm-350m")
    cfg = dataclasses.replace(full, n_layers=layers)
    cuts = [f"B=1, S={seq} (of train_4k's 4096: the host-bound sLSTM loop)",
            f"{layers} of {full.n_layers} layers", f"{steps} steps on one batch"]
    counts, _ = model_training(dev, "train_xlstm", cfg, full,
                               text_batch(dev, full, 1, seq, seed), steps, cuts,
                               blocks=("slstm", "mlstm"))
    red = full.reduced()
    grad_parity(dev, "train_xlstm_parity", red, M.init_params(red, seed=seed + 1, device="cpu"),
                text_batch("cpu", red, 2, parity_seq, seed + 1), witness_draws=2)
    return counts


def jamba_training(dev, seed=0, steps=3, seq=4096, experts=2, parity_seq=300) -> dict:
    """jamba-v0.1-52b at full width (d_model 4096, Din 8192, 32 / 8 heads,
    d_ff and each expert 14336, vocab 65536) cut to one period (8 of its
    32 layers: 7 mamba, 1 attention, 4 MoE) and ``experts`` of its 16
    experts, top 2 kept: ~3.9 B parameters, bf16 with bf16 AdamW moments
    (one period with 16 experts is ~13.7 B, ~200 GB to train), B = 1, S =
    ``seq``; the train steps (``model_training``), the selective scan
    through its Function, one mamba layer's forward and backward timed
    alone.  Then ``train_jamba_parity``: a reduced jamba (one period, 4
    experts top 2, d_model 256) in f32 at S = ``parity_seq`` (two scan
    chunks), card against CPU, the scan's and the router's gradients
    included."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=len(full.block_pattern),
                              moe=dataclasses.replace(full.moe, n_experts=experts))
    cuts = [f"{cfg.n_layers} of {full.n_layers} layers (one period)",
            f"{experts} of {full.moe.n_experts} experts (top {cfg.moe.top_k}: every token "
            "reaches both)", f"B=1, S={seq}", "bf16 AdamW moments", f"{steps} steps on one batch"]
    counts, _ = model_training(dev, "train_jamba", cfg, full, text_batch(dev, cfg, 1, seq, seed),
                               steps, cuts, opt_dtype="bfloat16", blocks=("mamba",))
    red = full.reduced(n_layers=len(full.block_pattern), d_model=256, n_heads=8, n_kv_heads=2,
                       d_head=32, vocab=4096)
    grad_parity(dev, "train_jamba_parity", red, M.init_params(red, seed=seed + 1, device="cpu"),
                text_batch("cpu", red, 1, parity_seq, seed + 1), experts=red.moe.n_experts,
                top_k=red.moe.top_k)
    return counts


def whisper_training(dev, seed=0, steps=3, batch=4, n_frames=AUDIO_CTX, n_tok=TEXT_CTX) -> dict:
    """whisper-medium at full width and depth (24 + 24 layers, bf16, f32
    AdamW moments), B = ``batch`` over 1500 frames and 448 tokens: the
    train steps (``model_training``): 72 flash_attention_bwd a step (24
    encoder, 24 decoder, 24 cross-attention)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("whisper-medium")
    frames = torch.randn((batch, n_frames, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(seed + 2),
                         device=dev).to(getattr(torch, cfg.dtype))
    return model_training(dev, "train_whisper", cfg, cfg,
                          text_batch(dev, cfg, batch, n_tok, seed, frames=frames), steps,
                          [f"B={batch}", f"{steps} steps on one batch"])[0]


def vlm_training(dev, seed=0, steps=3, n_text=3840) -> dict:
    """internvl2-1b at full width and depth (24 layers, 14 / 2 heads, bf16,
    f32 AdamW moments), B = 1 over its 256 patch embeddings and ``n_text``
    tokens (the ``vlm`` phase's cut of prefill_32k), the prefix's labels
    masked: the train steps (``model_training``)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("internvl2-1b")
    pfx = torch.randn((1, cfg.n_prefix_embeds, cfg.d_model),
                      generator=torch.Generator(device=dev).manual_seed(seed + 2),
                      device=dev).to(getattr(torch, cfg.dtype))
    return model_training(dev, "train_vlm", cfg, cfg,
                          text_batch(dev, cfg, 1, n_text, seed, prefix_embeds=pfx), steps,
                          [f"B=1, {cfg.n_prefix_embeds} patch embeddings + {n_text} tokens "
                           "(prefill_32k cut as the vlm phase cuts it)",
                           f"{steps} steps on one batch"])[0]


def encdec_training_parity(dev, seed=0, shapes=((64, 128), (256, 64)), vlm_text=128) -> None:
    """``train_encdec_parity``: f32 loss and gradients, card against CPU,
    of a reduced whisper (2 + 2 layers, d_model 256, 16 / 16 heads of 64)
    at each (frames, tokens) of ``shapes`` — 64 frames under 128 tokens
    put more queries than keys in the cross-attention's backward — and a
    reduced internvl2 (2 layers, 14 / 2 heads of 64) over its 8 prefix
    embeddings and ``vlm_text`` tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    rs = np.random.RandomState(seed)
    wh = get_config("whisper-medium").reduced(d_model=256, n_heads=16, n_kv_heads=16, d_head=64,
                                              vocab=4096)
    host = M.init_params(wh, seed=seed + 1, device="cpu")
    for n_frames, n_tok in shapes:
        frames = torch.from_numpy(rs.randn(1, n_frames, wh.d_model).astype(np.float32))
        grad_parity(dev, "train_encdec_parity", wh, host,
                    text_batch("cpu", wh, 1, n_tok, seed + n_frames, frames=frames),
                    cross_more_queries=n_tok > n_frames)
    vl = get_config("internvl2-1b").reduced(d_model=256, n_heads=14, n_kv_heads=2, d_head=64,
                                            vocab=4096)
    pfx = torch.from_numpy(rs.randn(1, vl.n_prefix_embeds, vl.d_model).astype(np.float32))
    grad_parity(dev, "train_encdec_parity", vl, M.init_params(vl, seed=seed + 2, device="cpu"),
                text_batch("cpu", vl, 1, vlm_text, seed + 3, prefix_embeds=pfx))


def train_phase(dev) -> dict:
    """The training path's main runs (the router's card loop, qwen3's,
    dbrx's, xlstm's, jamba's, whisper's and internvl2's steps), each
    counted from zero and read just after, their launch counts summed;
    the f32 parities between them."""
    runs = [router_training(dev), qwen3_training(dev), dbrx_training(dev), kimi_training(dev),
            xlstm_training(dev), jamba_training(dev), whisper_training(dev), vlm_training(dev)]
    encdec_training_parity(dev)
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def main(argv: list[str]) -> int:
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
    if argv[:1] == ["--durable-child"]:
        return durable_child(dev, argv[1], int(argv[2]))
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

    # the floor of one kernel node under device_ms's instrument: a
    # one-element op captured in a graph, its input rotated over copies
    floor = graph_ms(lambda x: x + 1, (torch.zeros(1, device=dev),))
    one_kernel_a_call("kernel node floor", floor)
    emit({"phase": "kernel_node_floor", "op": "x + 1 on one float32 element", **floor})

    entries = model_kernels(dev)
    entries.update(attention_kernels(dev))
    entries.update(router_kernels(dev, floor["device_ms"]))
    entries.update(backward_kernels(dev))
    entries.update(split_decode_kernels(dev))

    rng = random.Random(0)
    store, dims, n_files, dev_eng, host = query_phase(dev, SCALE_LOG2)
    batches = wave_batches(rng, dims, n_files)
    entries.update(storage_kernels(dev, dev_eng, batches["q1"][1], batches["q4"][1]))

    # the query path: counts from zero, read just after
    ops.reset_launches()
    drive_waves("before_write", dev_eng, host, batches)
    new, refresh_ms = write_wave(dev_eng, dims, rng)
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
    path_counts = [query_counts, durable_phase(dev, DURABLE_SCALE_LOG2, refresh_ms), serving_phase(dev),
                   serving_phase(dev, model_oracle=True), prefill_phase(dev), moe_phase(dev),
                   kimi_phase(dev),
                   recurrent_phase(dev, "jamba-v0.1-52b", 8),
                   recurrent_phase(dev, "xlstm-350m", 8), encdec_phase(dev), vlm_phase(dev),
                   train_phase(dev), mesh_single_rank(dev), head_dim_decode(dev),
                   recurrent_tp(dev)]
    dryrun_phase()

    kernels = []
    for name in ("path_lookup", "prefix_search", "rmsnorm", "decode_attention",
                 "flash_attention", "moe_router", "flash_attention_bwd", "rmsnorm_bwd",
                 "moe_router_bwd", "decode_scores", "decode_combine"):
        e = entries[name]
        e["launches"] = sum(c[name] for c in path_counts)
        e["node_floor_ms"] = floor["device_ms"]
        check(e["launches"] > 0, f"{name} was never launched on the main path")
        kernels.append({k: e[k] for k in ("name", "route", "source", "replaces", "launches",
                                          "max_abs_err", "ms", "device_ms",
                                          "device_ms_profiled", "host_ms",
                                          "plain_ms", "bound_ms", "bound_by", "node_floor_ms",
                                          "library_ms",
                                          "library_device_ms", "library_host_ms", "shape",
                                          "geometry", "note", "shapes")
                        if k in e})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

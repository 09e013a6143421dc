#!/usr/bin/env python3
"""Time one checkout's backward kernels on the card, so that two trees can
be compared within one run.

    python3 scripts/time_backward.py [--forward [--sweep]] [--bodies] [--train] [--host]
                                     [CHECKOUT ...]
    python3 scripts/time_backward.py --router [--sweep] [CHECKOUT ...]

For each CHECKOUT (default: this one), a directory holding that tree's
``chip_smoke.py`` and ``src/``, a process of its own builds the tree's
kernels and runs its smoke's backward phase (``backward_kernels``:
flash_attention_bwd and rmsnorm_bwd against their plain versions, timed
beside the library's autograd backward and their bounds); with
``--forward`` first the tree's flash_attention at this script's own
checkout's ``FLASH_SHAPES`` (the rows of ``FLASH_WITH_LSE`` with the lse
written), held to the plain version and timed with this
checkout's ``graph_ms`` beside SDPA's graph time (and ``ms``: events
around one call, host work included), the bound, at
head_dim 64 and below the exponentials' bound, and for an f32 row the
bound at 3xTF32's rate and the tree's key split (``--sweep``: every bf16
row at every query tile the tree's kernel takes, and after the backward
phase its f32 rows at dQ splits 1-4 with the query-tile blocks first and
last); with ``--bodies`` the f32 rows of the backward once more with S
and dP on wgmma and on mma.sync, forced through the tree's
``f32_bwd_wgmma`` (a tree without it prints that it has none); with
``--host`` the router's host-bound main paths, the tree's own
``chip_smoke``: the ModelOracle's serving run on the card
(``serve_once``: ms per NLL, mean and median) and 20 ``train_router``
steps (``router_loop``: the median step ms); with ``--train`` also its
qwen3-1.7B, dbrx-132b (one layer) and internvl2-1b training
(``qwen3_training``, ``dbrx_training``, ``vlm_training``: steps at full
width, each step's ms and split by kernel kind).

With ``--router`` the process builds the tree's ``moe_router`` library
alone (printing ``-Xptxas -v``'s registers and spills) and times the
tree's ``moe_router_bwd`` at this script's own checkout's
``ROUTER_BWD_SHAPES``, renormalized and not, with this checkout's
``graph_ms`` (a replayed CUDA graph, inputs rotated through twice the
L2; ``device_ms_warm``: the same inputs every call, warm in L2), its
bytes bound and the node floor of the same process (one
one-element op in a graph) beside each row, the profiler's time of the
kernel and of the autograd backward of softmax -> topk -> renorm (the
library yardstick), a plain ``torch.zeros_like`` of the (T, E) output
under the same graph timer, and the launch geometry where the tree has
``router_bwd_geometry``; ``--sweep`` also times every warps-a-block
count from 1 to 32 there.  Each result is held against the plain version
first.  The rows, timer and bounds are this script's checkout's, so that
every tree is held to one yardstick.

Each phase prints its JSON lines, tagged with the checkout.  Give the
trees in turns (parent, change, change, parent) to compare them on one
card.  Needs a card.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ("--forward", "--train", "--router", "--sweep", "--bodies", "--host")
SWEEP_WARPS = (1, 2, 4, 8, 16, 32)
SWEEP_TILES = (64, 128, 192)
SWEEP_DQ_SPLITS = (1, 2, 3, 4)


def own_smoke():
    """This script's own checkout's ``chip_smoke`` (rows, timer, bounds)."""
    spec = importlib.util.spec_from_file_location("own_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_forward(own, tag: str, sweep: bool) -> None:
    """The tree's flash_attention at ``own.FLASH_SHAPES``: held to the plain
    version, then the graph time of it and of SDPA on the same inputs; with
    ``sweep`` each bf16 row also at every query tile of SWEEP_TILES that the
    tree's kernel takes (192: head_dim 64 and below), its ``query_tile``
    forced."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    planned = fa.query_tile
    for shape, B, Hq, Hkv, Sq, Skv, D, dt, causal in own.FLASH_SHAPES:
        dtype = getattr(torch, dt)
        lse = shape in own.FLASH_WITH_LSE
        q = torch.randn((B, Hq, Sq, D), generator=g).to(dev, dtype)
        k = torch.randn((B, Hkv, Skv, D), generator=g).to(dev, dtype)
        v = torch.randn((B, Hkv, Skv, D), generator=g).to(dev, dtype)
        want = ref.attention_ref(q, k, v, causal=causal)
        nbytes, flops = own.attn_work(B, Hq, Hkv, Sq, Skv, D, causal, q.element_size())
        b, by = own.bound(nbytes, flops, own.BF16_FLOPS if dtype == torch.bfloat16
                          else own.F32_FLOPS)
        mask = own.sdpa_mask(q, k, causal)
        lib = own.graph_ms(lambda q, k, v: own.sdpa(q, k, v, causal, mask), (q, k, v),
                           calls=20)["device_ms"]
        plan = None
        if dt == "bfloat16":
            try:
                plan = planned(B, Hq, Sq, D=D)
            except TypeError:               # a tree whose tile does not follow head_dim
                plan = planned(B, Hq, Sq)
        tiles = [None]
        if sweep and dt == "bfloat16":
            tiles += [t for t in SWEEP_TILES if t != plan and (t < 192 or D <= 64)]
        for tile in tiles:
            if tile is not None:
                fa.query_tile = lambda *a, tile=tile, **kw: tile
            try:
                got = fa.flash_attention(q, k, v, causal=causal)
            except RuntimeError as e:       # a tile this tree's kernel does not take
                print(json.dumps({"checkout": tag, "row": shape, "query_tile": tile,
                                  "refused": str(e)}), flush=True)
                continue
            finally:
                fa.query_tile = planned
            if tile is not None:
                fa.query_tile = lambda *a, tile=tile, **kw: tile
            try:
                err = own.check_float(f"flash_attention ({shape}, tile {tile or plan})", got,
                                      want, dtype)
                ms = own.graph_ms(lambda q, k, v: fa.flash_attention(q, k, v, causal=causal,
                                                                     with_lse=lse),
                                  (q, k, v), calls=20)["device_ms"]
                host = own.cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                              with_lse=lse))
            finally:
                fa.query_tile = planned
            print(json.dumps({"checkout": tag, "phase": "flash_forward", "row": shape, "B": B,
                              "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Skv": Skv, "D": D, "dtype": dt,
                              "causal": causal, "max_abs_err": err, "plan": tile is None,
                              "query_tile": tile or plan, "device_ms": ms, "ms": host,
                              "library_device_ms": lib, "vs_library": ms / lib,
                              "bound_ms": b, "bound_by": by,
                              "exp_bound_ms": own.exp_bound_ms(flops, D) if D <= 64 else None,
                              "with_lse": lse, **f32_route(own, fa, B, Hq, Sq, Skv, D, dt,
                                                           causal, nbytes, flops)}),
                  flush=True)
        del q, k, v, want
    torch.cuda.empty_cache()


def f32_route(own, fa, B, Hq, Sq, Skv, D, dt, causal, nbytes, flops) -> dict:
    """An f32 row's bound at 3xTF32's rate and the tree's key split (a
    tree without one: None)."""
    if dt != "float32":
        return {}
    from repro_torch.kernels import build
    split = getattr(fa, "key_split", None)
    return {"tf32x3_bound_ms": own.bound(nbytes, flops, own.TF32X3_FLOPS)[0],
            "key_split": split(B, Hq, Sq, Skv, D, causal, build.sm_count(0)) if split else None}


def run_bwd_splits(own, tag: str) -> None:
    """The tree's float32 backward at the f32 rows of ``own.FLASH_BWD_SHAPES``
    at every dQ split of SWEEP_DQ_SPLITS, the query-tile blocks first and
    last in the grid (``bwd_geometry``'s ``dq_first`` forced), each held to
    the plain version and timed by the profiler beside SDPA's backward; a
    tree without ``dq_split`` prints that it has none."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    if not hasattr(fa, "dq_split"):
        print(json.dumps({"checkout": tag, "phase": "bwd_splits", "refused": "no dq_split"}),
              flush=True)
        return
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    geometry, planned = fa.bwd_geometry, fa.dq_split
    for shape, B, Hq, Hkv, Sq, Skv, D, dt, causal in own.FLASH_BWD_SHAPES:
        if dt != "float32":
            continue
        q, do = (torch.randn((B, Hq, Sq, D), generator=g).to(dev) for _ in range(2))
        k, v = (torch.randn((B, Hkv, Skv, D), generator=g).to(dev) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        mask = own.sdpa_mask(q, k, causal)
        lib = own.library_grad(lambda a, b, c: own.sdpa(a, b, c, causal, mask), (q, k, v), do)
        lib_ms = own.profiled_ms(lambda: lib(), (), 3)
        for d in SWEEP_DQ_SPLITS:
            for first in (True, False):
                fa.dq_split = lambda *a, d=d, **kw: d
                fa.bwd_geometry = lambda *a, f=first, **kw: geometry(*a, **kw)._replace(
                    dq_first=f)
                try:
                    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
                    err = max(own.check_grad(f"flash_attention_bwd ({shape}, d {d})", a, b,
                                             torch.float32) for a, b in zip(got, want))
                    ms = own.profiled_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                                        causal=causal), (), 3)
                finally:
                    fa.dq_split, fa.bwd_geometry = planned, geometry
                print(json.dumps({"checkout": tag, "phase": "bwd_splits", "row": shape,
                                  "dq_split": d, "dq_first": first,
                                  "planned": d == planned(B, Hq, Hkv, Sq, Skv,
                                                          causal=causal) and
                                  first == geometry(B, Hq, Hkv, Sq, Skv, False,
                                                    causal=causal).dq_first,
                                  "max_abs_err": err, "device_ms_profiled": ms,
                                  "library_device_ms": lib_ms}), flush=True)
        del q, k, v, do, o, lse, lib


def run_bwd_bodies(own, tag: str) -> None:
    """The tree's float32 backward at the f32 rows of ``own.FLASH_BWD_SHAPES``
    with S and dP on wgmma and on mma.sync (``f32_bwd_wgmma`` forced; wgmma
    where the tree's kernel takes it), each held to the plain version and
    timed by the profiler beside SDPA's backward."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    body = getattr(fa, "f32_bwd_wgmma", None)
    if body is None:
        print(json.dumps({"checkout": tag, "phase": "bwd_bodies", "refused": "no f32_bwd_wgmma"}),
              flush=True)
        return
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    for shape, B, Hq, Hkv, Sq, Skv, D, dt, causal in own.FLASH_BWD_SHAPES:
        if dt != "float32":
            continue
        q, do = (torch.randn((B, Hq, Sq, D), generator=g).to(dev) for _ in range(2))
        k, v = (torch.randn((B, Hkv, Skv, D), generator=g).to(dev) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        mask = own.sdpa_mask(q, k, causal)
        lib = own.library_grad(lambda a, b, c: own.sdpa(a, b, c, causal, mask), (q, k, v), do)
        lib_ms = own.profiled_ms(lambda: lib(), (), 3)
        for wg in (True, False):
            fa.f32_bwd_wgmma = lambda *a, w=wg, **kw: w
            try:
                got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
                err = max(own.check_grad(f"flash_attention_bwd ({shape}, wgmma {wg})", a, b,
                                         torch.float32) for a, b in zip(got, want))
                ms = own.profiled_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                                    causal=causal), (), 3)
            except RuntimeError as e:       # a head_dim whose wgmma tiles do not fit
                print(json.dumps({"checkout": tag, "phase": "bwd_bodies", "row": shape,
                                  "s_on_wgmma": wg, "refused": str(e)}), flush=True)
                continue
            finally:
                fa.f32_bwd_wgmma = body
            print(json.dumps({"checkout": tag, "phase": "bwd_bodies", "row": shape,
                              "s_on_wgmma": wg, "planned": wg == body(D), "max_abs_err": err,
                              "device_ms_profiled": ms, "library_device_ms": lib_ms}),
                  flush=True)
        del q, k, v, do, o, lse, lib


def host_us(fn, calls: int = 400) -> float:
    """The median host time of one call of ``fn`` in microseconds: the
    wrapper's work and the launch, not the card's (a synchronize every 50
    calls keeps the queue short)."""
    import statistics
    import time

    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def run_host(tag: str) -> None:
    """The router's host-bound main paths with the tree's own smoke: the
    host time of one float32 flash_attention call at an NLL's shape (1,
    4/2, 37, 64) and at the training forward's with its lse (8, 4/2, 128,
    64), and of one flash_attention_bwd call at the training shape; the
    ModelOracle's serving run on the card (ms per NLL); and 20
    train_router steps (the median step, the first left out)."""
    import statistics
    import tempfile

    import chip_smoke
    import torch
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(4)
    calls = {}
    for name, B, S, lse in (("nll", 1, 37, False), ("train", 8, 128, True)):
        q = torch.randn((B, 4, S, 64), generator=g).to(dev)
        k, v = (torch.randn((B, 2, S, 64), generator=g).to(dev) for _ in range(2))
        calls[f"fwd_{name}_host_us"] = host_us(lambda: fa.flash_attention(q, k, v, with_lse=lse))
        if lse:
            o, ls = fa.flash_attention(q, k, v, with_lse=True)
            do = torch.randn_like(q)
            calls["bwd_train_host_us"] = host_us(lambda: fa.flash_attention_bwd(q, k, v, o, ls,
                                                                                do))
    run = chip_smoke.serve_once(dev, True)
    ms = run["oracle"]["ms"]
    with tempfile.TemporaryDirectory(prefix="time_backward_") as tmp:
        loop = chip_smoke.router_loop(dev, tmp, 20, 20)
        times = loop.run().step_times
    print(json.dumps({"checkout": tag, "phase": "router_host", **calls, "nll_calls": len(ms),
                      "oracle_ms_per_nll": statistics.mean(ms),
                      "oracle_ms_per_nll_median": statistics.median(ms),
                      "train_router_step_ms": statistics.median(times[1:]) * 1e3,
                      "train_router_step_ms_all": [t * 1e3 for t in times]}), flush=True)


def run_one(root: Path, forward: bool, train: bool, sweep: bool, bodies: bool = False,
            host: bool = False) -> int:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_backward: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.models.layers import set_fp32_matmul
    set_fp32_matmul()
    print(json.dumps({"checkout": str(root), "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi(),
                      "nvcc_s": build.build_all()}), flush=True)
    dev = torch.device("cuda")
    if host:
        run_host(str(root))
    if forward:
        run_forward(own_smoke(), str(root), sweep)
    chip_smoke.backward_kernels(dev)
    if sweep:
        run_bwd_splits(own_smoke(), str(root))
    if bodies:
        run_bwd_bodies(own_smoke(), str(root))
    if train:
        chip_smoke.qwen3_training(dev)
        chip_smoke.dbrx_training(dev)
        chip_smoke.vlm_training(dev, steps=6)   # host-bound: a median of 5 steps
    return 0


def run_router(root: Path, sweep: bool) -> int:
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("time_backward: no CUDA device is available", file=sys.stderr)
        return 1
    own = own_smoke()   # the rows, timer and bounds of this script's own checkout
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import moe_router as mr
    tag = str(root)
    seconds = build.build_all(["moe_router"])
    log = build.BUILD_DIR / "moe_router.log"
    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    floor = own.graph_ms(lambda x: x + 1, (one,))["device_ms"]
    print(json.dumps({"checkout": tag, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": own.nvidia_smi(), "nvcc_s": seconds,
                      "node_floor_ms": floor,
                      "node_floor_profiled_ms": own.profiled_ms(lambda x: x + 1, (one,), 10),
                      "ptxas": [ln.strip() for ln in (log.read_text().splitlines()
                                                      if log.exists() else [])
                                if "registers" in ln or "spill" in ln or "Compiling" in ln]}),
          flush=True)
    geometry = getattr(mr, "router_bwd_geometry", None)
    g = torch.Generator(device="cpu").manual_seed(2)
    for name, T, E, k in own.ROUTER_BWD_SHAPES:
        x = torch.randn((T, E), generator=g).to(dev) * 2
        dw = torch.randn((T, k), generator=g).to(dev)
        for renorm in (True, False):
            w, idx = mr.moe_router(x, k, renormalize=renorm)
            lg = None if renorm else x

            def kernel(a, b, c, d, renorm=renorm, E=E):
                return mr.moe_router_bwd(a, b, c, d, renormalize=renorm, n_experts=E)
            got = kernel(lg, w, idx, dw)
            want = ref.moe_router_bwd_ref(x, w, idx, dw, renormalize=renorm)
            own.check_grad(f"moe_router_bwd ({name})", got, want, torch.float32)
            own.check(torch.equal(kernel(lg, w, idx, dw), got),
                       f"moe_router_bwd ({name}) is not bit for bit repeatable")
            nbytes = T * k * 12 + T * E * 4 + (0 if renorm else T * E * 4)
            b, by = own.bound(nbytes, T * k * 4.0 + (0 if renorm else T * E * 8.0),
                               own.F32_FLOPS)
            lib = own.library_grad(lambda z, k=k, r=renorm: own.router_library(z, k, r)[0],
                                    (x,), dw)
            row = {"checkout": tag, "row": name, "T": T, "E": E, "k": k, "renormalize": renorm,
                   "bound_ms": b, "bound_by": by, "node_floor_ms": floor,
                   "device_ms_profiled": own.profiled_ms(kernel, (lg, w, idx, dw), 10),
                   "library_device_ms": own.profiled_ms(lib, (), 10),
                   # a plain fill of the (T, E) output: what any kernel
                   # that writes it pays, read from the same graph timer
                   "fill_device_ms": own.graph_ms(torch.zeros_like, (x,))["device_ms"]}
            plans = [None]
            if geometry is not None:
                L, P, W, _ = geometry(T, E, k)
                row["geometry"] = {"lanes_a_token": L, "pieces_a_lane": P, "warps_a_block": W}
                if sweep:
                    plans += [w_ for w_ in SWEEP_WARPS
                              if w_ != W and w_ <= mr.bwd_max_warps(L)]
            for warps in plans:
                if warps is not None:     # the same lanes, another block size
                    def forced(T_, E_, k_, W=warps):
                        L_, P_, _, _ = geometry(T_, E_, k_)
                        warps_all = -(-T_ // (32 // L_))
                        return L_, P_, W, -(-warps_all // W)
                    mr.router_bwd_geometry = forced
                try:
                    gm = own.graph_ms(kernel, (lg, w, idx, dw), replays=20)
                finally:
                    if geometry is not None:
                        mr.router_bwd_geometry = geometry
                own.one_kernel_a_call(f"moe_router_bwd ({name})", gm)
                ms = gm["device_ms"]
                warm = None
                if warps is None:           # the same inputs every call
                    warm = own.graph_ms(kernel, (lg, w, idx, dw), replays=20,
                                         rotate=False)["device_ms"]
                print(json.dumps({**row, "warps_a_block": warps, "plan": warps is None,
                                  "device_ms": ms, "device_ms_warm": warm,
                                  "share_of_bound": b / ms, "over_node_floor": ms / floor}),
                      flush=True)
    return 0


def main(argv: list[str]) -> int:
    forward, train, router, sweep, bodies, host = (f in argv for f in FLAGS)
    roots = [a for a in argv if a not in FLAGS]
    if len(roots) == 1 and roots[0].startswith("--one="):
        root = Path(roots[0][len("--one="):]).resolve()
        return (run_router(root, sweep) if router
                else run_one(root, forward, train, sweep, bodies, host))
    rc = 0
    for root in roots or [str(ROOT)]:
        cmd = [sys.executable, __file__, f"--one={root}"] + [f for f in FLAGS if f in argv]
        rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time one checkout's backward kernels on the card, so that two trees can
be compared within one run.

    python3 scripts/time_backward.py [--forward [--sweep]] [--train] [CHECKOUT ...]
    python3 scripts/time_backward.py --router [--sweep] [CHECKOUT ...]

For each CHECKOUT (default: this one), a directory holding that tree's
``chip_smoke.py`` and ``src/``, a process of its own builds the tree's
kernels and runs its smoke's backward phase (``backward_kernels``:
flash_attention_bwd and rmsnorm_bwd against their plain versions, timed
beside the library's autograd backward and their bounds); with
``--forward`` first the tree's flash_attention at this script's own
checkout's ``FLASH_SHAPES``, held to the plain version and timed with this
checkout's ``graph_ms`` beside SDPA's graph time, the bound and, at
head_dim 64 and below, the exponentials' bound (``--sweep``: every bf16
row at every query tile the tree's kernel takes); with ``--train`` also its
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
FLAGS = ("--forward", "--train", "--router", "--sweep")
SWEEP_WARPS = (1, 2, 4, 8, 16, 32)
SWEEP_TILES = (64, 128, 192)


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
                ms = own.graph_ms(lambda q, k, v: fa.flash_attention(q, k, v, causal=causal),
                                  (q, k, v), calls=20)["device_ms"]
            finally:
                fa.query_tile = planned
            print(json.dumps({"checkout": tag, "phase": "flash_forward", "row": shape, "B": B,
                              "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Skv": Skv, "D": D, "dtype": dt,
                              "causal": causal, "max_abs_err": err, "plan": tile is None,
                              "query_tile": tile or plan, "device_ms": ms,
                              "library_device_ms": lib, "vs_library": ms / lib,
                              "bound_ms": b, "bound_by": by,
                              "exp_bound_ms": own.exp_bound_ms(flops, D) if D <= 64 else None}),
                  flush=True)
        del q, k, v, want
    torch.cuda.empty_cache()


def run_one(root: Path, forward: bool, train: bool, sweep: bool) -> int:
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
    if forward:
        run_forward(own_smoke(), str(root), sweep)
    chip_smoke.backward_kernels(dev)
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
    forward, train, router, sweep = (f in argv for f in FLAGS)
    roots = [a for a in argv if a not in FLAGS]
    if len(roots) == 1 and roots[0].startswith("--one="):
        root = Path(roots[0][len("--one="):]).resolve()
        return run_router(root, sweep) if router else run_one(root, forward, train, sweep)
    rc = 0
    for root in roots or [str(ROOT)]:
        cmd = [sys.executable, __file__, f"--one={root}"] + [f for f in FLAGS if f in argv]
        rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time one checkout's head_dim-split decode kernels (decode_scores,
decode_combine) on the card, so that two trees can be compared within
one run and a kernel's stream told apart from its fixed cost.

    python3 scripts/time_split.py [--sweep] [CHECKOUT ...]

For each CHECKOUT (default: this one), a directory holding that tree's
``src/``, a process of its own builds the tree's decode_scores and
decode_combine libraries (printing ``-Xptxas -v``'s registers, shared
memory and spills for every kernel instance) and times both kernels
under the smoke's ``graph_ms`` (a replayed CUDA graph, inputs rotated
through twice the L2) at the smoke's SPLIT_SHAPES rows: qwen3-1.7B's
16-rank and 2-rank slices, dbrx's group of 6, kimi-k2's Dl of 7,
internvl2's Dl of 4, the dry run's decode_32k slice (B = 8 a "data"
rank, S = 32768, Dl 8) and the router's f32 slice, with three length
patterns: the smoke's mixed lanes, every lane at S, and every lane at 1;
beside each row, one ``torch.sum`` over its whole V slice and its scores
(a streaming read of the same bytes as decode_combine at every lane at S:
what a plain read reaches on this card at that size).  decode_combine
is timed on its plan and forced to one block a (sequence, KV head); with
``--sweep`` also on 8, 16 and 32 blocks, and decode_scores on one tile a
block beside its plan.  Each row carries its bytes bound
(``chip_smoke.split_bounds``; the rows, the timer and the bound are this
script's own checkout's, so that every tree is held to one yardstick).
One JSON line per row, tagged with the checkout.  Give the trees in turns
(parent, change, change, parent) to compare them on one card.  Needs a
card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def patterns(B: int, S: int) -> dict[str, list[int]]:
    mixed = [1, S // 4 + 3, S // 2 + 1, S]
    return {"mixed": (mixed * (B // 4 + 1))[:B], "all S": [S] * B, "all 1": [1] * B}


def run_one(root: Path, sweep: bool) -> int:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_split: no CUDA device is available", file=sys.stderr)
        return 1
    import importlib.util

    from repro_torch.kernels import build
    # the rows, timer and bounds of this script's own checkout, so that two
    # trees are timed and held alike
    spec = importlib.util.spec_from_file_location("split_rows", ROOT / "chip_smoke.py")
    mine = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mine)
    from repro_torch.kernels import decode_split as dsp
    tag = str(root)
    names = ["decode_scores", "decode_combine"]
    seconds = build.build_all(names)
    logs = [build.BUILD_DIR / f"{n}.log" for n in names]
    print(json.dumps({"checkout": tag, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": mine.nvidia_smi(), "nvcc_s": seconds,
                      "ptxas": [ln.strip() for log in logs if log.exists()
                                for ln in log.read_text().splitlines()
                                if "registers" in ln or "spill" in ln or "Compiling" in ln]}),
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    plan, splan = dsp.combine_plan, dsp.scores_plan
    for name, B, Hq, Hkv, S, D, ranks, dname in mine.SPLIT_SHAPES:
        Dl, G, dt = D // ranks, Hq // Hkv, getattr(torch, dname)
        elt = dt.itemsize
        peak = mine.BF16_FLOPS if dt == torch.bfloat16 else mine.F32_FLOPS
        q = torch.randn((B, Hq, Dl), generator=g).to(dev, dt)
        k = torch.randn((B, Hkv, S, Dl), generator=g).to(dev, dt)
        v = torch.randn((B, Hkv, S, Dl), generator=g).to(dev, dt)
        s_all = torch.randn((B, Hq, S), generator=g).to(dev)
        read = mine.graph_ms(lambda v, s: v.sum(dtype=torch.float32) + s.sum(),
                                   (v, s_all))["device_ms"]
        nbytes = v.numel() * elt + s_all.numel() * 4
        print(json.dumps({"checkout": tag, "row": name, "kernel": "torch.sum of V and scores",
                          "bytes": nbytes, "device_ms": read,
                          "gb_per_s": nbytes / read / 1e6}), flush=True)
        del s_all
        for pat, lens in patterns(B, S).items():
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            live = sum(lens)
            s = dsp.decode_scores(q, k, ln, sm_scale=D ** -0.5)
            (b_s, _), (b_c, _) = mine.split_bounds(B, Hq, Hkv, S, Dl, elt, live, peak)
            row = {"checkout": tag, "row": name, "lengths": pat, "B": B, "G": G, "S": S,
                   "Dl": Dl, "dtype": dname, "live": live}
            for one_tile in ((False, True) if sweep else (False,)):
                if one_tile:   # every tile its own block
                    dsp.scores_plan = lambda B, Hkv, S, tile, n_sm: (B * Hkv * -(-S // tile), 1)
                try:
                    ms = mine.graph_ms(lambda q, k, ln: dsp.decode_scores(
                        q, k, ln, sm_scale=D ** -0.5), (q, k, ln))["device_ms"]
                finally:
                    dsp.scores_plan = splan
                print(json.dumps({**row, "kernel": "decode_scores", "plan": not one_tile,
                                  "device_ms": ms, "bound_ms": b_s,
                                  "share_of_bound": b_s / ms}), flush=True)
            nblk = plan(B, Hkv, S, dsp.combine_span_min(G, Dl, elt), build.sm_count(0))
            for blocks in sorted({nblk, 1} | ({8, 16, 32} if sweep else set()), reverse=True):
                dsp.combine_plan = (lambda *a, n=blocks, **kw: n)
                try:
                    ms = mine.graph_ms(dsp.decode_combine, (s, v, ln))["device_ms"]
                finally:
                    dsp.combine_plan = plan
                print(json.dumps({**row, "kernel": "decode_combine", "blocks": blocks,
                                  "plan": blocks == nblk, "device_ms": ms, "bound_ms": b_c,
                                  "share_of_bound": b_c / ms}), flush=True)
    return 0


def main(argv: list[str]) -> int:
    sweep = "--sweep" in argv
    roots = [a for a in argv if a != "--sweep"]
    if len(roots) == 1 and roots[0].startswith("--one="):
        return run_one(Path(roots[0][len("--one="):]).resolve(), sweep)
    rc = 0
    for root in roots or [str(ROOT)]:
        cmd = [sys.executable, __file__, f"--one={root}"] + (["--sweep"] if sweep else [])
        rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

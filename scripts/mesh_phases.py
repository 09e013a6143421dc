#!/usr/bin/env python3
"""The mesh phases of ``chip_smoke.py`` alone on one card: build the
kernels, then ``split_decode_kernels`` (decode_scores and decode_combine
at the head_dim layout's shapes), ``mesh_single_rank`` (the one-rank NCCL
mesh: the router's meshed train step under both remat policies,
``meshed_steps`` and ``memory_check``), ``head_dim_decode`` (the head_dim
layout's meshed decode over two threaded ranks on the card) and
``dryrun_phase`` (the dry-run cells and their 16x16 limits), each phase's
JSON line as the smoke prints it.

    python3 scripts/mesh_phases.py          # from the root of a checkout, on the card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.models.layers import set_fp32_matmul
    set_fp32_matmul()
    print(CS.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    CS.split_decode_kernels(dev)
    counts = CS.mesh_single_rank(dev)
    print(f"mesh_single_rank launches {counts}", flush=True)
    counts = CS.head_dim_decode(dev)
    print(f"head_dim_decode launches {counts}", flush=True)
    CS.dryrun_phase()
    print("mesh phases ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

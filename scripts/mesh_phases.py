#!/usr/bin/env python3
"""The mesh phases of ``chip_smoke.py`` alone on one card: build the
kernels, then ``split_decode_kernels`` (decode_scores and decode_combine
at the head_dim layout's shapes), ``mesh_single_rank`` (the one-rank NCCL
mesh: the router's meshed train step under both remat policies,
``meshed_steps`` and ``memory_check``), ``head_dim_decode`` (the head_dim
layout's meshed decode over two threaded ranks on the card),
``recurrent_tp`` (jamba's and xlstm's recurrent blocks tensor-parallel
over the same two threaded ranks) and ``dryrun_phase`` (the dry-run cells
and their 16x16 limits), each phase's JSON line as the smoke prints it.

    python3 scripts/mesh_phases.py [PHASE ...]   # from the root of a checkout, on the card

PHASE is any of split_decode_kernels, mesh_single_rank, head_dim_decode,
recurrent_tp and dryrun_phase; all of them, in that order, without one.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


PHASES = ("split_decode_kernels", "mesh_single_rank", "head_dim_decode", "recurrent_tp",
          "dryrun_phase")


def main(argv: list[str]) -> int:
    unknown = set(argv) - set(PHASES)
    if unknown:
        print(f"mesh_phases: unknown phases {sorted(unknown)}; choose from {PHASES}",
              file=sys.stderr)
        return 2
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
    for name in [p for p in PHASES if p in argv or not argv]:
        got = getattr(CS, name)() if name == "dryrun_phase" else getattr(CS, name)(dev)
        if name != "split_decode_kernels" and got is not None:
            print(f"{name} launches {got}", flush=True)
    print("mesh phases ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

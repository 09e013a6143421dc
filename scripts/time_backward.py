#!/usr/bin/env python3
"""Time one checkout's backward kernels on the card, so that two trees can
be compared within one run.

    python3 scripts/time_backward.py [--train] [CHECKOUT ...]

For each CHECKOUT (default: this one), a directory holding that tree's
``chip_smoke.py`` and ``src/``, a process of its own builds the tree's
kernels and runs its smoke's backward phase (``backward_kernels``:
flash_attention_bwd and rmsnorm_bwd against their plain versions, timed
beside the library's autograd backward and their bounds); with
``--train`` also its qwen3-1.7B training (``qwen3_training``: 5 steps at
full width, the step's split by kernel kind).  Each phase prints its JSON
lines, tagged with the checkout.  Give the trees in turns (parent,
change, change, parent) to compare them on one card.  Needs a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_one(root: Path, train: bool) -> int:
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
    chip_smoke.backward_kernels(dev)
    if train:
        chip_smoke.qwen3_training(dev)
    return 0


def main(argv: list[str]) -> int:
    train = "--train" in argv
    roots = [a for a in argv if a != "--train"]
    if len(roots) == 1 and roots[0].startswith("--one="):
        return run_one(Path(roots[0][len("--one="):]).resolve(), train)
    rc = 0
    for root in roots or [str(ROOT)]:
        cmd = [sys.executable, __file__, f"--one={root}"] + (["--train"] if train else [])
        rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

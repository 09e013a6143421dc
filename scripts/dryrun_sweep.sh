#!/bin/bash
# The dry run of every arch but jamba and xlstm (whose train_4k and
# prefill_32k trace their scans op by op for minutes), on both meshes, one
# process per arch and mesh, 8 at once; the cells' JSON in OUT/json, their
# logs in OUT/log, one summary line each.  Fake "cuda" tensors need
# PyTorch built with CUDA (the card's machine); pass DEVICE=cpu elsewhere.
#   bash scripts/dryrun_sweep.sh [OUT]        (default chiprun_out/sweep)
OUT=${1:-chiprun_out/sweep}
DEVICE=${DEVICE:-cuda}
mkdir -p "$OUT/json" "$OUT/log"
export OUT DEVICE
run() {
  set -- $1
  PYTHONPATH=src OMP_NUM_THREADS=1 python -m repro_torch.launch.dryrun --arch "$1" --mesh "$2" \
    --device "$DEVICE" --out-dir "$OUT/json" > "$OUT/log/$1_$2.log" 2>&1
}
export -f run
for arch in qwen3-1.7b codeqwen1.5-7b granite-8b olmo-1b internvl2-1b whisper-medium dbrx-132b \
            kimi-k2-1t-a32b; do
  for mesh in single multi; do echo "$arch $mesh"; done
done | xargs -P 8 -I{} bash -c 'run "{}"'
grep -h "^\[" "$OUT"/log/*.log
grep -h "DRYRUN SUMMARY" "$OUT"/log/*.log | sort | uniq -c

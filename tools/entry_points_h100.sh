#!/usr/bin/env bash
# The port's measurement entry points at their full lengths on one GPU.
#
#   bash tools/entry_points_h100.sh [NAME ...]
#
# First `chip_smoke.py`'s phases 30-33 alone (the entry points at short
# lengths, with their checks; the run stops if they fail), then each entry
# point at the lengths PERF.md records: the bench at its defaults, with
# --batch 0 and with --fused-pyramid pallas_hbm; the stage timing at its
# defaults and at the bench's --max-kpts 6144 --batch 8; the stereo/RGB-D
# longrun at 300 frames, chunks 1 8 32; the endurance run at 4,541 frames.
# Each command's stdout and stderr go to $OUT/NAME.out and .err (OUT
# defaults to the git-ignored trace/entry_points; stderr's first line:
# nvidia-smi's name and power limit); this script prints their last
# lines, exit codes and seconds.  With NAMEs, only those runs follow the
# phases (bench, bench_pair, bench_hbm, stage_times, stage_times_6144,
# stereo_longrun, endurance).
set -u
only=" $* "
out=${OUT:-trace/entry_points}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'

run() {
    local name=$1
    shift
    if [ "$only" != "  " ] && [ "$name" != phases_30_33 ] && [[ "$only" != *" $name "* ]]; then
        return 0
    fi
    echo "== $name: $*"
    local start=$SECONDS
    timeout "${LIMIT:-1800}" "$@" > "$out/$name.out" 2> "$out/$name.err"
    local rc=$?
    echo "rc=$rc seconds=$((SECONDS - start))"
    tail -n 4 "$out/$name.out"
    tail -n 2 "$out/$name.err"
    return $rc
}

run phases_30_33 python -c '
import time
import chip_smoke
import torch
from cusift_tpu_torch.kernels import _build
_build.library()
t0 = time.perf_counter()
chip_smoke.entry_points(torch.device("cuda", 0))
print("phases 30-33 seconds", round(time.perf_counter() - t0, 3))
' || exit 1

run bench python -m cusift_tpu_torch.bench
run bench_pair python -m cusift_tpu_torch.bench --batch 0
run bench_hbm python -m cusift_tpu_torch.bench --fused-pyramid pallas_hbm
run stage_times python -m cusift_tpu_torch.scripts.stage_times
run stage_times_6144 python -m cusift_tpu_torch.scripts.stage_times --max-kpts 6144 --batch 8
run stereo_longrun python -m cusift_tpu_torch.scripts.stereo_longrun
run endurance python -m cusift_tpu_torch.scripts.endurance

#!/usr/bin/env bash
# Time the tracking paths of two checkouts in turns on one GPU:
# `python -m cusift_tpu_torch.scripts.stereo_longrun` at its defaults (300
# frames, chunks 1, 8 and 32, stereo and RGB-D) and chip_smoke.py's phases
# 14, 16 and 18 (`tools/tracking_phases.py`).
#
#   bash tools/track_turns.sh PARENT_DIR CHANGE_DIR
#
# Each run starts in its checkout's directory, so it imports that
# checkout's package and builds that checkout's kernels; for example the
# parent commit unpacked with `git archive <commit> | tar -x -C
# trace/parent` beside the working tree (`.`).  The turns go parent,
# change, change, parent.  Each run's stdout and stderr go to
# $OUT/TURN_NAME.out and .err (OUT defaults to the git-ignored
# trace/track_turns); the script prints nvidia-smi's name and power limit,
# then each run's result lines, its exit code and seconds.
set -u
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
tool=$(cd "$(dirname "$0")" && pwd)/tracking_phases.py
out=$(mkdir -p "${OUT:-trace/track_turns}" && cd "${OUT:-trace/track_turns}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

run() {
    local tag=$1 dir=$2 pattern=$3
    shift 3
    local t0=$SECONDS
    (cd "$dir" && python "$@") > "$out/$tag.out" 2> "$out/$tag.err"
    local rc=$?
    echo "== $tag rc=$rc seconds=$((SECONDS - t0))"
    grep -E "$pattern" "$out/$tag.out" | cut -c1-400
    [ $rc -eq 0 ] || tail -n 3 "$out/$tag.err"
}

i=0
for turn in parent change change parent; do
    i=$((i + 1))
    dir=$parent
    [ "$turn" = change ] && dir=$change
    run "${i}_${turn}_longrun" "$dir" 'frames_per_s' -m cusift_tpu_torch.scripts.stereo_longrun
    run "${i}_${turn}_phases" "$dir" '^\[(slam|chunk|stereo_slam|tracking_phases)\] (image|tracking)' "$tool"
done

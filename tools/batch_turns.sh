#!/usr/bin/env bash
# Time the batched extraction's entry points of two checkouts in turns on
# one GPU: `python -m cusift_tpu_torch.scripts.stage_times` and `python -m
# cusift_tpu_torch.bench`, each at its defaults.
#
#   bash tools/batch_turns.sh PARENT_DIR CHANGE_DIR
#
# Each run starts in its checkout's directory, so it imports that
# checkout's package and builds that checkout's kernels (phase28_alone.py's
# pattern); for example the parent commit unpacked with `git archive
# <commit> | tar -x -C trace/parent` beside the working tree (`.`).  The
# turns go parent, change, change, parent.  Each run's stdout and stderr go
# to $OUT/TURN_NAME.out and .err (OUT defaults to the git-ignored
# trace/batch_turns); the script prints nvidia-smi's name and power limit,
# then each run's stage lines or the bench's headline line, its exit code
# and seconds.
set -u
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
out=$(mkdir -p "${OUT:-trace/batch_turns}" && cd "${OUT:-trace/batch_turns}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

run() {
    local tag=$1 dir=$2
    shift 2
    local t0=$SECONDS
    (cd "$dir" && python "$@") > "$out/$tag.out" 2> "$out/$tag.err"
    local rc=$?
    echo "== $tag rc=$rc seconds=$((SECONDS - t0))"
    grep -v '^{"per_frame_ms"' "$out/$tag.out" | tail -n 8
    tail -n 1 "$out/$tag.err"
}

i=0
for turn in parent change change parent; do
    i=$((i + 1))
    dir=$parent
    [ "$turn" = change ] && dir=$change
    run "${i}_${turn}_stage_times" "$dir" -m cusift_tpu_torch.scripts.stage_times
    run "${i}_${turn}_bench" "$dir" -m cusift_tpu_torch.bench
done

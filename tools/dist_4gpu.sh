#!/usr/bin/env bash
# The port's multi-GPU paths on a host with 4 GPUs, each against its
# one-GPU run: frame-sharded extraction and the Schur BA on 1, 2 and 4
# GPUs (`cli dist`), `dryrun_multichip(4)`, and `slam --dist` / `odo
# --dist` as 4 torchrun ranks beside the plain commands (the printed ATE
# must agree).  Run from the repository root: bash tools/dist_4gpu.sh
set -x
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m cusift_tpu_torch.cli dist || exit 1
python -c "from cusift_tpu_torch import entry; print('dryrun4', entry.dryrun_multichip(4))" || exit 1
python -m cusift_tpu_torch.cli slam --synthetic 12 || exit 1
python -m torch.distributed.run --standalone --nproc-per-node 4 \
    -m cusift_tpu_torch.cli slam --synthetic 12 --dist || exit 1
python -m cusift_tpu_torch.cli odo --synthetic 8 --ba-window 4 || exit 1
python -m torch.distributed.run --standalone --nproc-per-node 4 \
    -m cusift_tpu_torch.cli odo --synthetic 8 --ba-window 4 --dist || exit 1

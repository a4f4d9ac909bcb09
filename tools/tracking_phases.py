"""Run `chip_smoke.py`'s tracking phases 14, 16 and 18 alone.

    cd CHECKOUT && python /path/to/tools/tracking_phases.py

Imports `chip_smoke` and `cusift_tpu_torch` from the directory it is
started in, so two checkouts (for example a parent commit unpacked with
`git archive` into `trace/parent`) can be timed in turns in one chip
call (`tools/track_turns.sh`).  Builds the kernels, runs phase 14 (the
48-frame RGB-D orbit at chunk 1, whose frames/s and keyframes phase 16
compares against), phase 16 (the orbit at chunk 8) and phase 18 (the
150-frame north-star stereo loop at chunks 1 and 8), each with its own
checks, and prints their lines.  Needs a CUDA device.
"""

import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402  (the checkout's own, from the cwd)

if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("tracking_phases: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from cusift_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    _build.library()
    t0 = time.perf_counter()
    _, _, stats = cs.slam_path(dev)
    cs.chunked_slam_path(dev, stats)
    cs.stereo_slam_path(dev, cs.stereo_scene())
    cs.log("tracking_phases", seconds=f"{time.perf_counter() - t0:.3f}",
           card=cs.json.dumps(cs.smi_line()))

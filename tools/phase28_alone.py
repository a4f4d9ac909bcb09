"""Run `chip_smoke.py`'s phase 28 (the map-anchored mono VO) alone.

    cd CHECKOUT && python /path/to/tools/phase28_alone.py

Imports `chip_smoke` and `cusift_tpu_torch` from the directory it is
started in, so two checkouts (for example a parent commit unpacked with
`git archive` into `trace/parent`) can be timed in turns in one chip
call: parent, change, change, parent.  Renders the north-star stereo
scene (phase 17's), then runs `map_vo_path` (untimed 16-frame warm-up,
then the 150 frames) and prints its `[map_vo]` line; the phase-20 fields
of that line are placeholders (phase 20 is not run).  Needs a CUDA device.
"""

import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402  (the checkout's own, from the cwd)

if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("phase28_alone: no CUDA device", file=sys.stderr)
        sys.exit(1)
    seq = cs.stereo_scene()
    chain = dict(ate=1.0, path=1.0, fps=0.0, frame_ms=[1.0], k2_per_frame=0.0, peak_mem_gb=0.0)
    cs.map_vo_path(torch.device("cuda", 0), seq, chain)

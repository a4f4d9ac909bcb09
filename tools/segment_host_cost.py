"""Host time of a segment-sum plan and call at the map refinement's shape.

    cd CHECKOUT && python /path/to/tools/segment_host_cost.py

Imports `cusift_tpu_torch` from the directory it is started in (so two
checkouts can be compared in turns).  On the map's layout (2,048 rows on
the first 512 of 8,192 segments, 402 on one; seed 12) and d = 1, 3, 6, it
prints the host microseconds of one `segment.segment_sum` call and of one
`segment.plan`, each the mean of 200 enqueued while the device spins (so
the device never holds the host back), twice.  Needs a CUDA device.
"""

import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from cusift_tpu_torch.kernels import segment  # noqa: E402  (the checkout's own)

SPIN_CYCLES = 400_000_000   # about 0.2 s of device time ahead of the host


def main() -> int:
    if not torch.cuda.is_available():
        print("segment_host_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(12)
    idx = torch.from_numpy(rng.permutation(np.concatenate([np.zeros(402, np.int64),
                                                           rng.integers(1, 512, 1646)]))).to(dev)
    for d in (1, 3, 6):
        x = torch.randn(2048, d, device=dev)
        x = x[:, 0].contiguous() if d == 1 else x
        p = segment.plan(idx, 8192)
        segment.segment_sum(x, p)
        torch.cuda.synchronize()
        for rep in range(2):
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(200):
                segment.segment_sum(x, p)
            call_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(200):
                segment.plan(idx, 8192)
            plan_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            print(f"d={d} rep={rep} call_us={call_us:.1f} plan_us={plan_us:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

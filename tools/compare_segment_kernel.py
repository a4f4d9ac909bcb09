"""Hold the segment-sum kernel against the same kernel built from another source.

    PYTHONPATH=. python tools/compare_segment_kernel.py OLD_SEGMENT_CU

OLD_SEGMENT_CU is a `cusift_tpu_torch/csrc/segment.cu` with the current
entry point, `cusift_segment_sum(x, order, offsets, out, n, d,
double_precision, stream)`, for example an earlier commit's, written out
with `git show <commit>:cusift_tpu_torch/csrc/segment.cu >
trace/segment_old.cu`.  The script builds it with nvcc into `trace/old_segment`
(git-ignored) and runs it and the package's own build on the same inputs,
at the shapes of the port's paths (`chip_smoke.py` phase 29): the landmark
refinement's 2048 rows into 8192 segments (d = 1 and 3) with the invalid
rows' 402 on one landmark, SfM BA's camera sums (3158 rows into 10, d = 36
and 6) and landmark sums (into 622, d = 9), and a Sim(3) CG scatter (128
rows into 33, d = 7).  It prints for each case whether the two are
bit-equal and equal to the CPU's `index_add_`, and both times taken in
turns (old, new, new, old) with CUDA events over 20 queued launches.  The
last line is one JSON object of the cases.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from cusift_tpu_torch.kernels import _build
from cusift_tpu_torch.kernels import segment

# (rows, segments, trailing shape, rows on segment 0) of each case
CASES = {"map refine cnt": (2048, 8192, (), 402), "map refine sum": (2048, 8192, (3,), 402),
         "sfm BA cameras": (3158, 10, (6, 6), 0), "sfm BA rhs": (3158, 10, (6,), 0),
         "sfm BA landmarks": (3158, 622, (3, 3), 0), "sim3 CG": (128, 33, (7,), 0)}


def _old_library(src: Path, build_dir: Path) -> ctypes.CDLL:
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / "libsegment_old.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    argtypes, restype = _build.SIGNATURES["cusift_segment_sum"]
    lib.cusift_segment_sum.argtypes = list(argtypes)
    lib.cusift_segment_sum.restype = restype
    return lib


def _old_sum(lib, x, p):
    out = torch.empty((p.n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    d = max(1, x[0].numel())
    err = lib.cusift_segment_sum(x.data_ptr(), p.order.data_ptr(), p.offsets.data_ptr(),
                                 out.data_ptr(), p.n, d, int(x.dtype == torch.float64),
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "old cusift_segment_sum")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", type=Path)
    ap.add_argument("--build-dir", type=Path, default=Path("trace/old_segment"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_segment_kernel: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    old = _old_library(args.old, args.build_dir)
    rng = np.random.default_rng(0)
    report = {}
    for name, (rows, n, tail, hot) in CASES.items():
        idx = rng.integers(0, n, rows)
        idx[rng.choice(rows, hot, replace=False)] = 0
        x = torch.from_numpy(rng.normal(size=(rows,) + tail).astype(np.float32))
        ref = torch.zeros((n,) + tail).index_add_(0, torch.from_numpy(idx), x)
        p = segment.plan(torch.from_numpy(idx).to(dev), n)
        xd = x.to(dev)
        a, b = _old_sum(old, xd, p), segment.segment_sum(xd, p)
        torch.cuda.synchronize()
        same = torch.equal(a, b) and torch.equal(b.cpu(), ref)
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            fn = ((lambda: _old_sum(old, xd, p)) if which == "old"
                  else (lambda: segment.segment_sum(xd, p)))
            times[which].append(cs.time_ms(fn, f"segment {name} {which}"))
        report[name] = dict(bit_equal=same, longest=int(np.bincount(idx, minlength=n).max()),
                            old_ms=times["old"], new_ms=times["new"])
        print(f"[segment] case={name!r} bit_equal={same} "
              f"longest={report[name]['longest']} "
              f"old_ms={','.join(f'{t:.4f}' for t in times['old'])} "
              f"new_ms={','.join(f'{t:.4f}' for t in times['new'])}", flush=True)
    print(cs.smi_line())
    print(json.dumps(report))
    return 0 if all(r["bit_equal"] for r in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

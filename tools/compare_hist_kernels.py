"""Hold K4 and K5 against the same kernels built from another sampler source.

    PYTHONPATH=. python tools/compare_hist_kernels.py OLD_SAMPLER_CU

OLD_SAMPLER_CU is a `cusift_tpu_torch/csrc/sampler.cu` whose K4 and K5
entry points launch one block per slot and take no plan arguments:

    cusift_sample_ori_hist(gauss, lvl, ys, xs, wv, hist, L, H, W, N, S, NB, stream)
    cusift_sample_desc_raw(gauss, lvl, ys, xs, theta, wv, w_spatial, raw,
                           L, H, W, N, S, NB, CELLS, stream)

for example an earlier commit's, written out with `git show
<commit>:cusift_tpu_torch/csrc/sampler.cu > trace/sampler_old.cu`.  The
script builds it with nvcc into `--build-dir` (default `trace/old_sampler`,
git-ignored), runs both forms on the same inputs at `chip_smoke.py`'s K4
and K5 shapes (the batch's five octaves; K5 with the descriptor's spatial
weights, and at octave 0 also with a dense random matrix; a few slots with
NaN points), and prints for each shape whether the outputs are bit-equal,
the largest difference, and both forms' times taken in turns (old, new,
new, old).  The last line is one JSON object of the cases.  Needs a CUDA
device.
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
from cusift_tpu_torch.kernels import sampler as k
from cusift_tpu_torch.ops.describe import _spatial_weights

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {
    "cusift_sample_ori_hist": ((_P,) * 6 + (_I,) * 6 + (_P,), _I),
    "cusift_sample_desc_raw": ((_P,) * 8 + (_I,) * 7 + (_P,), _I),
}


def build_old(src: Path, build_dir: Path) -> ctypes.CDLL:
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / "libold_sampler.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in OLD_SIGNATURES.items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = restype
    return lib


def _old_call(lib, name, *args):
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)


def _compare(label, new_fn, old_fn) -> dict:
    new, old = new_fn(), old_fn()
    torch.cuda.synchronize()
    diff = (new - old).abs()
    both_nan = torch.isnan(new) & torch.isnan(old)
    equal = bool(torch.equal(new.view(torch.int32), old.view(torch.int32)))
    times = [cs.time_ms(f, f"{label} {tag}") for f, tag in
             ((old_fn, "old"), (new_fn, "new"), (new_fn, "new"), (old_fn, "old"))]
    case = dict(case=label, bit_equal=equal,
                max_abs_diff=float(diff[~both_nan].max().item()) if diff.numel() else 0.0,
                differing=int((new.view(torch.int32) != old.view(torch.int32)).sum()),
                old_ms=[times[0], times[3]], new_ms=[times[1], times[2]])
    cs.log("compare", **{key: (f"{v:.4f}" if isinstance(v, float) else v)
                         for key, v in case.items() if not isinstance(v, list)},
           old_ms=f"{times[0]:.4f},{times[3]:.4f}", new_ms=f"{times[1]:.4f},{times[2]:.4f}")
    return case


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source", type=Path)
    ap.add_argument("--build-dir", type=Path, default=Path("trace/old_sampler"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_hist_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = build_old(args.old_source, args.build_dir)
    gen = np.random.default_rng(0)
    _, wsp, gw = (torch.from_numpy(a).to(dev) for a in _spatial_weights(12, 4))
    cases = []
    L, S = 3, 144
    for o, ((H, W), n4, n5) in enumerate(zip(cs.OCTAVE_SHAPES, cs.ORI_SLOTS,
                                             cs.DESC_SLOTS)):
        gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, n4, S)
        ys[20:24] = float("nan")
        wv = torch.from_numpy(gen.uniform(0, 1, (n4, S)).astype(np.float32)).to(dev)
        hist = torch.empty((n4, 36), device=dev)
        cases.append(_compare(
            f"k4 octave{o} N{n4}", lambda: k.sample_ori_hist(gauss, lvl, ys, xs, wv, 36),
            lambda: (_old_call(lib, "cusift_sample_ori_hist",
                               *k._ptrs(gauss, lvl, ys, xs, wv, hist), L, H, W, n4, S, 36),
                     hist)[1]))

        gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, n5, S)
        ys[20:24] = float("nan")
        theta = torch.from_numpy(gen.uniform(0, 2 * np.pi, n5).astype(np.float32)).to(dev)
        weights = [("descriptor", wsp, gw[None, :].expand(n5, -1).contiguous())]
        if o == 0:
            weights.append(("dense", torch.from_numpy(
                gen.uniform(0, 1, (S, 16)).astype(np.float32)).to(dev), torch.from_numpy(
                gen.uniform(0, 1, (n5, S)).astype(np.float32)).to(dev)))
        for tag, w_sp, wv in weights:
            raw = torch.empty((n5, 8, 16), device=dev)
            cases.append(_compare(
                f"k5 octave{o} N{n5} {tag}",
                lambda: k.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, w_sp, 8),
                lambda: (_old_call(lib, "cusift_sample_desc_raw",
                                   *k._ptrs(gauss, lvl, ys, xs, theta, wv, w_sp, raw),
                                   L, H, W, n5, S, 8, 16), raw)[1]))
    print(cs.smi_line())
    print(json.dumps({"cases": cases,
                      "all_bit_equal": all(c["bit_equal"] for c in cases)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

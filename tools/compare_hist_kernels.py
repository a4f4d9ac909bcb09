"""Hold K1, K4, K5 and K6 against the same kernels built from another sampler source.

    PYTHONPATH=. python tools/compare_hist_kernels.py OLD_SAMPLER_CU

OLD_SAMPLER_CU is a `cusift_tpu_torch/csrc/sampler.cu` whose entry points
take the arguments the current ones do:

    cusift_sample_grad_patches(gauss, lvl, ys, xs, dx, dy, inb, L, H, W, N, S, stream)
    cusift_sample_grad_patches_sep(gauss, lvl, ys_rows, xs_cols, dx, dy, inb,
                                   L, H, W, N, GR, GC, stream)
    cusift_sample_ori_hist(gauss, lvl, ys, xs, wv, hist, L, H, W, N, S, NB,
                           SLOTS, CHUNK, THREADS, SMEM, stream)
    cusift_sample_desc_raw(gauss, lvl, ys, xs, theta, wv, w_spatial, raw,
                           L, H, W, N, S, NB, CELLS, SLOTS, CHUNK, THREADS, SMEM, stream)

for example an earlier commit's, written out with `git show
<commit>:cusift_tpu_torch/csrc/sampler.cu > trace/sampler_old.cu`.  The
script builds it with nvcc into `--build-dir` (default `trace/old_sampler`,
git-ignored) and runs both forms on the same inputs:

  * K1 (dx, dy and inb) at `chip_smoke.py`'s phase-3 shape (L=3, 960x1280,
    N=3840, S=144, random points within 25 px of each centre, border and
    outside points included), at the path's descriptor and orientation
    geometries, with NaN and inf points, on h = 2 and w = 2 stacks, an odd
    width, N = 1, half the slots spread over 200 px, and at each of the 20
    launches of one two-view pair (`chip_smoke.py`'s main path, whose
    inputs are recorded as it runs), with their sum;
  * K6 at `chip_smoke.py`'s shape (N=3072 slots of 12 x 12), since it
    shares the sampling function of K4 and K5;
  * K4 and K5 at `chip_smoke.py`'s shapes (the batch's five octaves; K5
    with the descriptor's spatial weights, and at octave 0 also with a
    dense random matrix; a few slots with NaN points).

It prints for each case whether the outputs are bit-equal, the largest
difference, and both forms' times taken in turns (old, new, new, old).
The last line is one JSON object of the cases.  Needs a CUDA device.
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

OLD_SIGNATURES = {name: _build.SIGNATURES[name] for name in (
    "cusift_sample_grad_patches", "cusift_sample_grad_patches_sep", "cusift_sample_ori_hist",
    "cusift_sample_desc_raw")}


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


def _compare(label, new_fn, old_fn, **extra) -> dict:
    """new_fn and old_fn each return a tuple of output tensors."""
    new, old = new_fn(), old_fn()
    torch.cuda.synchronize()
    words = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    equal = all(torch.equal(words(a), words(b)) for a, b in zip(new, old))
    differing = sum(int((words(a) != words(b)).sum()) for a, b in zip(new, old))
    diffs = [(a - b)[~(torch.isnan(a) & torch.isnan(b))].abs() for a, b in zip(new, old)
             if a.is_floating_point()]
    times = [cs.time_ms(f, f"{label} {tag}") for f, tag in
             ((old_fn, "old"), (new_fn, "new"), (new_fn, "new"), (old_fn, "old"))]
    case = dict(case=label, bit_equal=equal,
                max_abs_diff=max((float(d.max()) for d in diffs if d.numel()), default=0.0),
                differing=differing, **extra,
                old_ms=[times[0], times[3]], new_ms=[times[1], times[2]])
    cs.log("compare", **{key: (f"{v:.4f}" if isinstance(v, float) else v)
                         for key, v in case.items() if not isinstance(v, list)},
           old_ms=f"{times[0]:.4f},{times[3]:.4f}", new_ms=f"{times[1]:.4f},{times[2]:.4f}")
    return case


def _k1_cases(gen, dev):
    """(label, gauss, lvl, ys, xs) of each K1 case."""
    L, H, W, N, S = 3, 960, 1280, 3840, 144
    gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, N, S)
    yield "k1 phase3", gauss, lvl, ys, xs
    for kind in ("descriptor", "orientation"):
        yield (f"k1 {kind}", gauss, *cs.path_points(gen, dev, kind, L, H, W))
    ys, xs = ys.clone(), xs.clone()
    ys[20:24, ::3] = float("nan")
    xs[24:28, ::5] = float("inf")
    ys[28:32, ::7] = -float("inf")
    ys[32] = float("nan")
    yield "k1 nan_inf", gauss, lvl, ys, xs
    for tag, (h, w) in (("h2", (2, 640)), ("w2", (480, 2)), ("odd_width", (200, 131))):
        yield (f"k1 {tag}", *cs._points(gen, dev, L, h, w, 500, S))
    yield ("k1 n1", *cs._points(gen, dev, L, H, W, 1, S))
    gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, 1001, S)
    ys[::2] += torch.from_numpy(gen.uniform(-100, 100, ys[::2].shape)
                                .astype(np.float32)).to(dev)
    yield "k1 wide", gauss, lvl, ys, xs
    for i, inputs in enumerate(_pair_launches(dev)):
        yield (f"k1 pair{i:02d}", *inputs)


def _pair_launches(dev) -> list[tuple]:
    """(gauss, lvl, ys, xs) of every K1 launch of `chip_smoke.py`'s main
    path: one `match_pair` of the bench pair, recorded as it runs."""
    from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
    from cusift_tpu_torch.data.synthetic import warped_pair
    from cusift_tpu_torch.models.twoview import match_pair

    got, launch = [], k.sample_grad_patches

    def record(*inputs):
        got.append(tuple(t.clone() for t in inputs))
        return launch(*inputs)

    ia, ib, _ = warped_pair(480, 640, seed=1, blobs=800, detail=0.25, detail_octaves=4)
    k.sample_grad_patches = record
    try:
        match_pair(torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev),
                   SiftConfig(**cs.BENCH_SIFT), MatchConfig(), RansacConfig(num_hypotheses=1024))
    finally:
        k.sample_grad_patches = launch
    return got


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
    sms = k._sm_count(dev.index)
    cases = []

    for label, gauss, lvl, ys, xs in _k1_cases(gen, dev):
        (l, h, w), (n, s) = gauss.shape, ys.shape
        out = (torch.empty((n, s), device=dev), torch.empty((n, s), device=dev),
               torch.empty((n, s), dtype=torch.bool, device=dev))
        cases.append(_compare(
            label, lambda: k.sample_grad_patches(gauss, lvl, ys, xs),
            lambda: (_old_call(lib, "cusift_sample_grad_patches",
                               *k._ptrs(gauss, lvl, ys, xs, *out), l, h, w, n, s), out)[1],
            shape=f"L{l}x{h}x{w},N{n},S{s}"))
    pair = [c for c in cases if c["case"].startswith("k1 pair")]
    pair_ms = dict(old_ms=[sum(c["old_ms"][j] for c in pair) for j in (0, 1)],
                   new_ms=[sum(c["new_ms"][j] for c in pair) for j in (0, 1)])
    cs.log("compare", case="k1 pair sum", launches=len(pair),
           old_ms=",".join(f"{v:.4f}" for v in pair_ms["old_ms"]),
           new_ms=",".join(f"{v:.4f}" for v in pair_ms["new_ms"]))

    # K6 shares K4's and K5's sampling function: its bits at chip_smoke.py's shape
    gauss, lvl, ys, xs = cs._points(gen, dev, 3, 960, 1280, 3072, 12)
    ys_rows, xs_cols = ys, xs.flip(1).contiguous()
    n = ys.shape[0]
    out = (torch.empty((n, 144), device=dev), torch.empty((n, 144), device=dev),
           torch.empty((n, 144), dtype=torch.bool, device=dev))
    cases.append(_compare(
        "k6 N3072 12x12", lambda: k.sample_grad_patches_sep(gauss, lvl, ys_rows, xs_cols),
        lambda: (_old_call(lib, "cusift_sample_grad_patches_sep",
                           *k._ptrs(gauss, lvl, ys_rows, xs_cols, *out), 3, 960, 1280, n, 12,
                           12), out)[1]))

    L, S = 3, 144
    _, wsp, gw = (torch.from_numpy(a).to(dev) for a in _spatial_weights(12, 4))
    for o, ((H, W), n4, n5) in enumerate(zip(cs.OCTAVE_SHAPES, cs.ORI_SLOTS,
                                             cs.DESC_SLOTS)):
        gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, n4, S)
        ys[20:24] = float("nan")
        wv = torch.from_numpy(gen.uniform(0, 1, (n4, S)).astype(np.float32)).to(dev)
        hist = torch.empty((n4, 36), device=dev)
        p4 = k._plan_args(k._launch_plan(n4, S, None, sms))
        cases.append(_compare(
            f"k4 octave{o} N{n4}", lambda: (k.sample_ori_hist(gauss, lvl, ys, xs, wv, 36),),
            lambda: (_old_call(lib, "cusift_sample_ori_hist",
                               *k._ptrs(gauss, lvl, ys, xs, wv, hist), L, H, W, n4, S, 36,
                               *p4), (hist,))[1]))

        gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, n5, S)
        ys[20:24] = float("nan")
        theta = torch.from_numpy(gen.uniform(0, 2 * np.pi, n5).astype(np.float32)).to(dev)
        weights = [("descriptor", wsp, gw[None, :].expand(n5, -1).contiguous())]
        if o == 0:
            weights.append(("dense", torch.from_numpy(
                gen.uniform(0, 1, (S, 16)).astype(np.float32)).to(dev), torch.from_numpy(
                gen.uniform(0, 1, (n5, S)).astype(np.float32)).to(dev)))
        p5 = k._plan_args(k._launch_plan(n5, S, 16, sms))
        for tag, w_sp, wv in weights:
            raw = torch.empty((n5, 8, 16), device=dev)
            cases.append(_compare(
                f"k5 octave{o} N{n5} {tag}",
                lambda: (k.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, w_sp, 8),),
                lambda: (_old_call(lib, "cusift_sample_desc_raw",
                                   *k._ptrs(gauss, lvl, ys, xs, theta, wv, w_sp, raw),
                                   L, H, W, n5, S, 8, 16, *p5), (raw,))[1]))
    print(cs.smi_line())
    print(json.dumps({"cases": cases, "k1_pair_sum": pair_ms,
                      "all_bit_equal": all(c["bit_equal"] for c in cases)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

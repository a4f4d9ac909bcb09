"""Hold K1, K4, K5 and K6 against the same kernels built from another sampler source.

    PYTHONPATH=. python tools/compare_hist_kernels.py OLD_SAMPLER_CU [--new NEW_SAMPLER_CU]
                                                     [--kernels k1,k4,k5,k6]

OLD_SAMPLER_CU is a `cusift_tpu_torch/csrc/sampler.cu` of one frame a
launch, whose entry points take these arguments (commit 3589398 up to
25fb2cc, the last before the frame axis):

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
git-ignored) and runs both forms on the same inputs.  "New" is the
package's own build (its entry points take B frames: `kernels/_build.py`'s
signatures), or with `--new` another source with the package's entry
points (a variant under trial), built beside the old one.  `--kernels`
picks the kernels compared (default all):

  * K1 (dx, dy and inb) at `chip_smoke.py`'s phase-3 shape (L=3, 960x1280,
    N=3840, S=144, random points within 25 px of each centre, border and
    outside points included), at the path's descriptor and orientation
    geometries, with NaN and inf points, on h = 2 and w = 2 stacks, an odd
    width, N = 1, half the slots spread over 200 px, and at each of the 20
    launches of one two-view pair (`chip_smoke.py`'s main path, whose
    inputs are recorded as it runs), with their sum;
  * K6 at `chip_smoke.py`'s random shape (N=3072 slots of 12 x 12), at the
    orientation grid of the separable path at its five octave shapes and
    slot budgets (with their sum, one image's five launches), and on rows
    and columns on the borders, NaN and inf rows and columns, GR != GC,
    N = 1, one sample a slot and 600 samples a slot;
  * K4 and K5 at `chip_smoke.py`'s shapes (the batch's five octaves; K5
    with the descriptor's spatial weights, and at octave 0 also with a
    dense random matrix; a few slots with NaN points);
  * each kernel over a batch of 8 frames in one launch (octaves 0 and 4 of
    the bench's shapes at the descriptor slot budgets, levels outside
    [0, L - 1] included) against the old form's 8 launches, one a frame:
    bit-equal, and timed in turns.

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

_P, _I = ctypes.c_void_p, ctypes.c_int
# the one-frame entry points of the sources before the frame axis
OLD_SIGNATURES = {
    "cusift_sample_grad_patches": ((_P,) * 7 + (_I,) * 5 + (_P,), _I),
    "cusift_sample_grad_patches_sep": ((_P,) * 7 + (_I,) * 6 + (_P,), _I),
    "cusift_sample_ori_hist": ((_P,) * 6 + (_I,) * 10 + (_P,), _I),
    "cusift_sample_desc_raw": ((_P,) * 8 + (_I,) * 11 + (_P,), _I),
}
NEW_SIGNATURES = {name: _build.SIGNATURES[name] for name in OLD_SIGNATURES}


def build(src: Path, build_dir: Path, stem: str, signatures: dict) -> ctypes.CDLL:
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / f"lib{stem}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in signatures.items():
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
        yield (f"k1 pair{i:02d}", *(t[0] for t in inputs))     # extract's B = 1


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


def _k6_cases(gen, dev):
    """(label, gauss, lvl, ys_rows, xs_cols) of each K6 case."""
    L, G = 3, 12
    (H, W), N = cs.OCTAVE_SHAPES[0], cs.ORI_SLOTS[0]
    gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, N, G)
    yield "k6 N3072 12x12", gauss, lvl, ys, xs.flip(1).contiguous()
    for o, ((h, w), n) in enumerate(zip(cs.OCTAVE_SHAPES, cs.ORI_SLOTS)):
        g = torch.from_numpy(gen.random((L, h, w), dtype=np.float32)).to(dev)
        yield (f"k6 orientation octave{o} N{n}", g, *cs.orientation_rows(gen, dev, n, L, h, w))
    ys_rows, xs_cols = ys.clone(), xs.clone()
    ys_rows[::2, ::3] = 0.0
    ys_rows[1::2, ::3] = H - 1.0
    xs_cols[::3, 1::4] = W - 1.0
    xs_cols[1::3, 2::4] = 0.5
    yield "k6 border", gauss, lvl, ys_rows, xs_cols
    ys_rows, xs_cols = ys.clone(), xs.clone()
    ys_rows[20:24, ::3] = float("nan")
    ys_rows[24] = float("nan")
    xs_cols[28:32, ::5] = float("inf")
    ys_rows[32:36, ::2] = -float("inf")
    yield "k6 nan_inf", gauss, lvl, ys_rows, xs_cols
    for tag, (n, gr, gc) in (("5x7", (1001, 5, 7)), ("n1", (1, 12, 12)), ("s1", (777, 1, 1)),
                             ("20x30", (99, 20, 30))):
        g, lv, y, x = cs._points(gen, dev, L, 240, 320, n, max(gr, gc))
        yield f"k6 {tag}", g, lv, y[:, :gr].contiguous(), x[:, :gc].contiguous()


def _call(lib, name, args, outs):
    """fn() that runs the C entry `name` of lib on args and returns outs."""
    return lambda: (_old_call(lib, name, *args), outs)[1]


def _sampling_compares(label, lib, new_lib, name, wrapper, inputs, dims, out_shape,
                       shape) -> dict:
    """K1 or K6: the new form (the package's wrapper, or new_lib's entry)
    against lib's entry on the same inputs; dims are the old entry's ints
    (L, H, W, then the slots'), and the new entry's take B = 1 after L, H, W."""
    n, s = out_shape
    dev = inputs[0].device
    outs = [(torch.empty((n, s), device=dev), torch.empty((n, s), device=dev),
             torch.empty((n, s), dtype=torch.bool, device=dev)) for _ in range(2)]
    new_fn = (lambda: wrapper(*inputs)) if new_lib is None else _call(
        new_lib, name, (*k._ptrs(*inputs, *outs[0]), *dims[:3], 1, *dims[3:]), outs[0])
    return _compare(label, new_fn, _call(lib, name, (*k._ptrs(*inputs, *outs[1]), *dims),
                                         outs[1]),
                    shape=shape)


def _summed(cases, prefix, label) -> dict:
    """old and new times of the cases whose label starts with prefix, summed."""
    picked = [c for c in cases if c["case"].startswith(prefix)]
    ms = {key: [sum(c[key][j] for c in picked) for j in (0, 1)] for key in ("old_ms", "new_ms")}
    cs.log("compare", case=label, launches=len(picked),
           old_ms=",".join(f"{v:.4f}" for v in ms["old_ms"]),
           new_ms=",".join(f"{v:.4f}" for v in ms["new_ms"]))
    return ms


def _hist_compares(gen, dev, lib, kernels) -> list[dict]:
    """K4 and K5 at the batch's five octave shapes against lib's."""
    L, S = 3, 144
    sms = k._sm_count(dev.index)
    _, wsp, gw = (torch.from_numpy(a).to(dev) for a in _spatial_weights(12, 4))
    cases = []
    for o, ((H, W), n4, n5) in enumerate(zip(cs.OCTAVE_SHAPES, cs.ORI_SLOTS,
                                             cs.DESC_SLOTS)):
        gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, n4, S)
        ys[20:24] = float("nan")
        wv = torch.from_numpy(gen.uniform(0, 1, (n4, S)).astype(np.float32)).to(dev)
        hist = torch.empty((n4, 36), device=dev)
        p4 = k._plan_args(k._launch_plan(n4, S, None, sms))
        if "k4" in kernels:
            cases.append(_compare(
                f"k4 octave{o} N{n4}", lambda: (k.sample_ori_hist(gauss, lvl, ys, xs, wv, 36),),
                _call(lib, "cusift_sample_ori_hist", (*k._ptrs(gauss, lvl, ys, xs, wv, hist),
                                                      L, H, W, n4, S, 36, *p4), (hist,))))

        gauss, lvl, ys, xs = cs._points(gen, dev, L, H, W, n5, S)
        ys[20:24] = float("nan")
        theta = torch.from_numpy(gen.uniform(0, 2 * np.pi, n5).astype(np.float32)).to(dev)
        weights = [("descriptor", wsp, gw[None, :].expand(n5, -1).contiguous())]
        if o == 0:
            weights.append(("dense", torch.from_numpy(
                gen.uniform(0, 1, (S, 16)).astype(np.float32)).to(dev), torch.from_numpy(
                gen.uniform(0, 1, (n5, S)).astype(np.float32)).to(dev)))
        p5 = k._plan_args(k._launch_plan(n5, S, 16, sms))
        for tag, w_sp, wv in weights if "k5" in kernels else ():
            raw = torch.empty((n5, 8, 16), device=dev)
            cases.append(_compare(
                f"k5 octave{o} N{n5} {tag}",
                lambda: (k.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, w_sp, 8),),
                _call(lib, "cusift_sample_desc_raw",
                      (*k._ptrs(gauss, lvl, ys, xs, theta, wv, w_sp, raw),
                       L, H, W, n5, S, 8, 16, *p5), (raw,))))
    return cases


def _batched_compares(gen, dev, lib, kernels) -> list[dict]:
    """Each kernel over B = 8 frames in one launch (the package's wrapper)
    against lib's one-frame entry launched on each frame in turn, into the
    same [B, ...] layout, at octaves 0 and 4 of the bench's shapes and
    descriptor slot budgets."""
    B, L, S, G = 8, 3, 144, 12
    sms = k._sm_count(dev.index)
    _, wsp, gw = (torch.from_numpy(a).to(dev) for a in _spatial_weights(G, 4))
    cases = []
    for o in (0, len(cs.OCTAVE_SHAPES) - 1):
        (H, W), n = cs.OCTAVE_SHAPES[o], cs.DESC_SLOTS[o]
        pts = [cs._points(gen, dev, L, H, W, n, S) for _ in range(B)]
        gauss, lvl, ys, xs = (torch.stack(t) for t in zip(*pts))
        ys[:, 20:24] = float("nan")
        wv = gw.expand(B, n, S).contiguous()
        theta = torch.from_numpy(gen.uniform(0, 2 * np.pi, (B, n)).astype(np.float32)).to(dev)
        rows, cols = ys[..., :G].contiguous(), xs[..., :G].contiguous()
        specs = {
            "k1": (lambda: k.sample_grad_patches(gauss, lvl, ys, xs), "cusift_sample_grad_patches",
                   lambda f: (gauss[f], lvl[f], ys[f], xs[f]), (L, H, W, n, S),
                   [(B, n, S)] * 2 + [(B, n, S, "bool")]),
            "k6": (lambda: k.sample_grad_patches_sep(gauss, lvl, rows, cols),
                   "cusift_sample_grad_patches_sep", lambda f: (gauss[f], lvl[f], rows[f], cols[f]),
                   (L, H, W, n, G, G), [(B, n, G * G)] * 2 + [(B, n, G * G, "bool")]),
            "k4": (lambda: (k.sample_ori_hist(gauss, lvl, ys, xs, wv, 36),),
                   "cusift_sample_ori_hist", lambda f: (gauss[f], lvl[f], ys[f], xs[f], wv[f]),
                   (L, H, W, n, S, 36, *k._plan_args(k._launch_plan(n, S, None, sms))),
                   [(B, n, 36)]),
            "k5": (lambda: (k.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, wsp, 8),),
                   "cusift_sample_desc_raw",
                   lambda f: (gauss[f], lvl[f], ys[f], xs[f], theta[f], wv[f], wsp),
                   (L, H, W, n, S, 8, 16, *k._plan_args(k._launch_plan(n, S, 16, sms))),
                   [(B, n, 8, 16)]),
        }
        for key in ("k1", "k4", "k5", "k6"):
            if key not in kernels:
                continue
            new_fn, name, frame_in, dims, shapes = specs[key]
            outs = [torch.empty(sh[:-1], dtype=torch.bool, device=dev) if sh[-1] == "bool"
                    else torch.empty(sh, device=dev) for sh in shapes]

            def old_fn(name=name, frame_in=frame_in, dims=dims, outs=outs):
                for f in range(B):
                    _old_call(lib, name, *k._ptrs(*frame_in(f), *(t[f] for t in outs)), *dims)
                return tuple(outs)

            cases.append(_compare(f"{key} batch{B} octave{o} N{n}", new_fn, old_fn,
                                  shape=f"B{B}xL{L}x{H}x{W},N{n}"))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source", type=Path)
    ap.add_argument("--new", type=Path, default=None,
                    help="a sampler source to build as the new form (K1 and K6 only; "
                         "default: the package's build)")
    ap.add_argument("--kernels", default="k1,k4,k5,k6")
    ap.add_argument("--build-dir", type=Path, default=Path("trace/old_sampler"))
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if args.new is not None and kernels & {"k4", "k5"}:
        ap.error("--new compares K1 and K6 only")
    if not torch.cuda.is_available():
        print("compare_hist_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = build(args.old_source, args.build_dir, "old_sampler", OLD_SIGNATURES)
    new_lib = (build(args.new, args.build_dir, "new_sampler", NEW_SIGNATURES) if args.new
               else None)
    gen = np.random.default_rng(0)
    cases, sums = [], {}

    if "k1" in kernels:
        for label, gauss, lvl, ys, xs in _k1_cases(gen, dev):
            cases.append(_sampling_compares(
                label, lib, new_lib, "cusift_sample_grad_patches", k.sample_grad_patches,
                (gauss, lvl, ys, xs), (*gauss.shape, *ys.shape), ys.shape,
                "L{}x{}x{},N{},S{}".format(*gauss.shape, *ys.shape)))
        sums["k1_pair_sum"] = _summed(cases, "k1 pair", "k1 pair sum")
    if "k6" in kernels:
        for label, gauss, lvl, ys_rows, xs_cols in _k6_cases(gen, dev):
            (n, gr), gc = ys_rows.shape, xs_cols.shape[1]
            cases.append(_sampling_compares(
                label, lib, new_lib, "cusift_sample_grad_patches_sep",
                k.sample_grad_patches_sep, (gauss, lvl, ys_rows, xs_cols),
                (*gauss.shape, n, gr, gc), (n, gr * gc),
                "L{}x{}x{},N{},{}x{}".format(*gauss.shape, n, gr, gc)))
        sums["k6_orientation_sum"] = _summed(cases, "k6 orientation",
                                             "k6 orientation sum (one image's five octaves)")
    if kernels & {"k4", "k5"}:
        cases += _hist_compares(gen, dev, lib, kernels)
    if args.new is None:
        cases += _batched_compares(gen, dev, lib, kernels)
    print(cs.smi_line())
    print(json.dumps({"cases": cases, **sums,
                      "all_bit_equal": all(c["bit_equal"] for c in cases)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

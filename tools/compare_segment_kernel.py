"""Hold the segment-sum kernel against the same kernel built from another source.

    PYTHONPATH=. python tools/compare_segment_kernel.py OLD_SEGMENT_CU [--variants SPEC]

OLD_SEGMENT_CU is a `cusift_tpu_torch/csrc/segment.cu` of the first form,
whose entry point is `cusift_segment_sum(x, order, offsets, out, n, d,
double_precision, stream)` (commit ab9d647's), written out with
`git show ab9d647:cusift_tpu_torch/csrc/segment.cu > trace/segment_old.cu`.
The script builds it with nvcc into `trace/old_segment` (git-ignored) and
runs it, through that signature on the plan's `order` and `offsets`, and
the package's own build on the same inputs, at the shapes of the port's
paths (`chip_smoke.py` phase 29): the landmark refinement's 2048 rows into
8192 segments (d = 1 and 3) with the invalid rows' 402 on one landmark,
SfM BA's camera sums (3158 rows into 10, d = 36 and 6) and landmark sums
(into 622, d = 9), a Sim(3) CG scatter (128 rows into 33, d = 7), and
phase 29's two synthetic inputs (a 4,096-row single segment at d = 3;
100,000 rows into 10,000 segments at d = 6).  It prints for each case
whether the two are bit-equal and equal to the CPU's `index_add_`, and
both times taken in turns (old, new, new, old) with CUDA events over 20
queued launches, with `index_add_` on the card beside them.

`--sources A.cu B.cu` builds each file (a form of `csrc/segment.cu` with
the current entry point) and times it in turns with the package's build
(package, A, A, package), each checked bit for bit: the way to time a
design under trial against the current one.  `--extra ROWS:N:D:HOT`
adds cases (HOT rows on segment 0).
`--variants "TILE=128,MAX_CHUNK=256;THREADS=512"` also times the new
kernel with `kernels/segment.py`'s launch constants set so (a plan made
anew for each), in turns with the defaults, each checked bit for bit: the
way to try a launch shape.  The last line is one JSON object of the
cases.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
         "sfm BA landmarks": (3158, 622, (3, 3), 0), "sim3 CG": (128, 33, (7,), 0),
         "single segment": (4096, 1, (3,), 0), "sfm scale": (100_000, 10_000, (6,), 0)}
# the first form's entry point: x, order, offsets, out, n, d, double_precision, stream
OLD_SIGNATURE = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,), ctypes.c_int)


def _libraries(srcs: list, build_dir: Path, signatures: list) -> list:
    """Each source built by its own nvcc, all at once, and bound to its
    signature."""
    build_dir.mkdir(parents=True, exist_ok=True)
    outs = [build_dir / f"libsegment_{i}_{src.stem}.so" for i, src in enumerate(srcs)]
    _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
                 for src, out in zip(srcs, outs)])
    libs = []
    for out, (argtypes, restype) in zip(outs, signatures):
        lib = ctypes.CDLL(str(out))
        lib.cusift_segment_sum.argtypes = list(argtypes)
        lib.cusift_segment_sum.restype = restype
        libs.append(lib)
    return libs


def _new_sum(lib, x, p):
    """`segment.segment_sum`'s launch through another build."""
    out = torch.empty((p.n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    d = max(1, x[0].numel())
    shape = segment.launch_shape(d, x.element_size())
    err = lib.cusift_segment_sum(
        x.data_ptr(), p.order.data_ptr(), p.seg.data_ptr(),
        p.ends.data_ptr(), p.blocks.data_ptr(), out.data_ptr(), x.shape[0], p.n, d,
        p.blocks.shape[0] - 1, p.tile, shape["d_tile"], shape["chunk"], shape["threads"],
        shape["smem"], int(x.dtype == torch.float64), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "variant cusift_segment_sum")
    return out


def _old_sum(lib, x, p):
    out = torch.empty((p.n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    d = max(1, x[0].numel())
    err = lib.cusift_segment_sum(x.data_ptr(), p.order.data_ptr(), p.offsets.data_ptr(),
                                 out.data_ptr(), p.n, d, int(x.dtype == torch.float64),
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "old cusift_segment_sum")
    return out


def _variant(spec: str) -> dict:
    """{"TILE": 128, ...} from "TILE=128,MAX_CHUNK=256"."""
    return {k: int(v) for k, v in (kv.split("=") for kv in spec.split(",") if kv)}


def _with(consts: dict, fn):
    """fn() with kernels/segment.py's launch constants set to `consts`."""
    saved = {k: getattr(segment, k) for k in consts}
    for k, v in consts.items():
        setattr(segment, k, v)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            setattr(segment, k, v)


def _variant_times(name, xd, idx_d, n, ref, p, variants: list) -> dict:
    """Each variant's kernel bit for bit against `ref`, timed in turns
    with the defaults (default, variant, variant, default)."""
    out = {}
    for spec in variants:
        consts = _variant(spec)
        pv = _with(consts, lambda: segment.plan(idx_d, n))
        got = _with(consts, lambda: segment.segment_sum(xd, pv))
        torch.cuda.synchronize()
        times = {"default": [], "variant": []}
        for which in ("default", "variant", "variant", "default"):
            fn = ((lambda: segment.segment_sum(xd, p)) if which == "default"
                  else (lambda: _with(consts, lambda: segment.segment_sum(xd, pv))))
            times[which].append(cs.time_ms(fn, f"segment {name} {spec} {which}"))
        out[spec] = dict(bit_equal=torch.equal(got.cpu(), ref), **times)
        print(f"[segment] case={name!r} variant={spec!r} bit_equal={out[spec]['bit_equal']} "
              f"default_ms={','.join(f'{t:.4f}' for t in times['default'])} "
              f"variant_ms={','.join(f'{t:.4f}' for t in times['variant'])}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", type=Path)
    ap.add_argument("--build-dir", type=Path, default=Path("trace/old_segment"))
    ap.add_argument("--variants", default="",
                    help="';'-separated launch constants of kernels/segment.py to time")
    ap.add_argument("--sources", type=Path, nargs="*", default=[],
                    help="other forms of csrc/segment.cu with the current entry point")
    ap.add_argument("--extra", nargs="*", default=[], help="more cases, ROWS:N:D:HOT")
    args = ap.parse_args()
    variants = [v for v in args.variants.split(";") if v]
    cases = dict(CASES)
    for spec in args.extra:
        rows, n, d, hot = map(int, spec.split(":"))
        cases[spec] = (rows, n, (d,) if d > 1 else (), hot)
    if not torch.cuda.is_available():
        print("compare_segment_kernel: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    old, *others = _libraries(
        [args.old, *args.sources], args.build_dir,
        [OLD_SIGNATURE] + [_build.SIGNATURES["cusift_segment_sum"]] * len(args.sources))
    rng = np.random.default_rng(0)
    report = {}
    for name, (rows, n, tail, hot) in cases.items():
        idx = rng.integers(0, n, rows)
        idx[rng.choice(rows, hot, replace=False)] = 0
        x = torch.from_numpy(rng.normal(size=(rows,) + tail).astype(np.float32))
        ref = torch.zeros((n,) + tail).index_add_(0, torch.from_numpy(idx), x)
        idx_d = torch.from_numpy(idx).to(dev)
        p = segment.plan(idx_d, n)
        xd = x.to(dev)
        a, b = _old_sum(old, xd, p), segment.segment_sum(xd, p)
        torch.cuda.synchronize()
        same = torch.equal(a, b) and torch.equal(b.cpu(), ref)
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            fn = ((lambda: _old_sum(old, xd, p)) if which == "old"
                  else (lambda: segment.segment_sum(xd, p)))
            times[which].append(cs.time_ms(fn, f"segment {name} {which}"))
        index_add_ms = cs.time_ms(lambda: segment.segment_sum_plain(xd, p),
                                  f"segment {name} index_add_")
        sources = {}
        for src, lib in zip(args.sources, others):
            got = _new_sum(lib, xd, p)
            torch.cuda.synchronize()
            ts = {"package": [], "source": []}
            for which in ("package", "source", "source", "package"):
                fn = ((lambda: segment.segment_sum(xd, p)) if which == "package"
                      else (lambda: _new_sum(lib, xd, p)))
                ts[which].append(cs.time_ms(fn, f"segment {name} {src.name} {which}"))
            sources[src.name] = dict(bit_equal=torch.equal(got.cpu(), ref), **ts)
            print(f"[segment] case={name!r} source={src.name} "
                  f"bit_equal={sources[src.name]['bit_equal']} "
                  f"package_ms={','.join(f'{t:.4f}' for t in ts['package'])} "
                  f"source_ms={','.join(f'{t:.4f}' for t in ts['source'])}", flush=True)
        report[name] = dict(bit_equal=same, longest=int(np.bincount(idx, minlength=n).max()),
                            old_ms=times["old"], new_ms=times["new"],
                            index_add_ms=index_add_ms, sources=sources,
                            variants=_variant_times(name, xd, idx_d, n, ref, p, variants))
        print(f"[segment] case={name!r} bit_equal={same} "
              f"longest={report[name]['longest']} "
              f"old_ms={','.join(f'{t:.4f}' for t in times['old'])} "
              f"new_ms={','.join(f'{t:.4f}' for t in times['new'])} "
              f"index_add_ms={index_add_ms:.4f}", flush=True)
    print(cs.smi_line())
    print(json.dumps(report))
    return 0 if all(r["bit_equal"] and all(v["bit_equal"] for v in r["variants"].values())
                    and all(v["bit_equal"] for v in r["sources"].values())
                    for r in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

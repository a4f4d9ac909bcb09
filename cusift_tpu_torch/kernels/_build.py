"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Every `csrc/*.cu` file exposes a plain C entry point, so the library is
compiled by `nvcc` alone in seconds (no PyTorch headers) and bound with
`ctypes`.  The build runs at first use, keyed by a hash of the sources and
flags, into `cusift_tpu_torch/_build/` next to the sources: one `nvcc -c`
per source, all started together, then one link into a single shared
library.  A missing `nvcc` or a failed compile raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sampler.cu", "matcher.cu", "octave.cu", "segment.cu", "homography.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

# C signature of each entry point: (argtypes, restype); every function
# returns its cudaError_t as an int.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # K1, K4-K6 take B frames of N slots each
    # K1: gauss, lvl, ys, xs, dx, dy, inb, L, H, W, B, N, S, stream
    "cusift_sample_grad_patches": ((_P,) * 7 + (_I,) * 6 + (_P,), _I),
    # K6: gauss, lvl, ys_rows, xs_cols, dx, dy, inb, L, H, W, B, N, GR, GC,
    #     stream
    "cusift_sample_grad_patches_sep": ((_P,) * 7 + (_I,) * 7 + (_P,), _I),
    # K4: gauss, lvl, ys, xs, wv, hist, L, H, W, B, N, S, NB, SLOTS, CHUNK,
    #     THREADS, SMEM, stream
    "cusift_sample_ori_hist": ((_P,) * 6 + (_I,) * 11 + (_P,), _I),
    # K5: gauss, lvl, ys, xs, theta, wv, w_spatial, raw, L, H, W, B, N, S,
    #     NB, CELLS, SLOTS, CHUNK, THREADS, SMEM, stream
    "cusift_sample_desc_raw": ((_P,) * 8 + (_I,) * 12 + (_P,), _I),
    # K2: a, b, valid_b, top, idx, part_top, part_idx, nbatch, N, M, D,
    #     stride_a, stride_b, stride_v (elements; 0 = shared), P,
    #     cols_per_split, stream
    "cusift_match_top2": ((_P,) * 7 + (_I,) * 4 + (_L,) * 3 + (_I,) * 2 + (_P,), _I),
    # K3: padded, samp, dog, score, taps (host), radii (host), nlev, R, B,
    #     H, W, band_rows, window_rows, vbuf_stride, smem_bytes, prefilter,
    #     stream
    "cusift_fused_octave": ((_P,) * 6 + (_I,) * 9 + (_F, _P), _I),
    # segment sum: x, order, seg, ends, blocks, out, rows, n, d, nb, tile,
    #     d_tile, chunk, threads, smem, double_precision, stream
    "cusift_segment_sum": ((_P,) * 6 + (_I,) * 10 + (_P,), _I),
    # RANSAC homography: valid, n, p, stream
    "cusift_homography_weights": ((_P, _I, _P, _P), _I),
    # pa, pb, valid, n, idx, nhyp, thr2, hs, counts, stream
    "cusift_homography_score": ((_P,) * 3 + (_I, _P, _I, _F) + (_P,) * 3, _I),
    # pa, pb, valid, n, hs, counts, nhyp, h_in, thr2, iters, min_matches,
    #     h_out, inliers, num, ok, stream
    "cusift_homography_refine": ((_P,) * 3 + (_I, _P, _P, _I, _P, _F, _I, _I) + (_P,) * 5,
                                 _I),
}

DEFAULT_CUDA_HOME = "/usr/local/cuda"
build_seconds = None   # wall time of the last compile in this process
build_log = ""         # nvcc's output of that compile (-Xptxas -v lines)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (CUDA_HOME, {DEFAULT_CUDA_HOME}, PATH): "
                           "the port's CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{text}")
    return "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled kernel library, building it first if needed."""
    global build_seconds, build_log
    out = BUILD_DIR / f"libcusift_kernels_{_digest()}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        objs = [str(tmp.with_suffix(f".{Path(s).stem}.o")) for s in SOURCES]
        t0 = time.perf_counter()
        build_log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
                          for src, obj in zip(SOURCES, objs)])
        build_log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]])
        build_seconds = time.perf_counter() - t0
        out.with_suffix(".log").write_text(build_log)
        os.replace(tmp, out)
        for obj in objs:
            os.remove(obj)
    elif out.with_suffix(".log").is_file():
        # a cached library: its compile's ptxas lines are kept beside it
        build_log = out.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

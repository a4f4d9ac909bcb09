"""RANSAC homography on the card (CUDA kernels `csrc/homography.cu`).

No TPU kernel is replaced: the reference's `find_homography` is one XLA
program.  Its eager twin (`ops/ransac.py`) is about 3,000 small ATen
operations a call, whose host dispatch paces the card; on a CUDA tensor
`find_homography` and `improve_homography` launch these kernels instead:

* `weights(valid)`: the weights `torch.multinomial` draws the samples
  from (valid as 0/1, all ones where no row is valid), in one launch;
* `score(pa, pb, valid, idx, thresh)`: each [4] row of `idx` solved to a
  homography and its inliers counted over all rows, -1 where it is not
  finite;
* `refine(pa, pb, valid, thresh, iters, min_matches, ...)`: the winner of
  the scoring (the first of the largest counts) or a given homography,
  `iters` IRLS rounds, and the result.

The arithmetic mirrors the plain version in float32 (see the source's
header), which `ops/ransac.py` keeps for CPU tensors and which the tests
and `chip_smoke.py` hold the kernels against.  Each wrapper checks its
inputs and raises on what the kernels do not take, and on a launch the
card refuses; there is no fallback.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build


def _rows(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor):
    """pa, pb [N, 2] float32 and valid [N] bool on one CUDA device, made
    contiguous; raises on anything else."""
    if pa.dtype != torch.float32 or pb.dtype != torch.float32:
        raise ValueError(f"homography kernels: points must be float32, not "
                         f"{pa.dtype} and {pb.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"homography kernels: valid must be bool, not {valid.dtype}")
    n = pa.shape[0] if pa.ndim == 2 else -1
    if pa.shape != (n, 2) or pb.shape != (n, 2) or valid.shape != (n,):
        raise ValueError(f"homography kernels: pa {tuple(pa.shape)}, pb {tuple(pb.shape)}, "
                         f"valid {tuple(valid.shape)}: want [N, 2], [N, 2], [N]")
    if n >= 2 ** 31:
        raise ValueError(f"homography kernels: {n} rows exceed int32")
    _device(pa, pb, valid)
    return pa.contiguous(), pb.contiguous(), valid.contiguous()


def _device(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"homography kernels: no kernel for {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError("homography kernels: the tensors lie on "
                         f"{sorted({str(t.device) for t in tensors})}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def weights(valid: torch.Tensor) -> torch.Tensor:
    """[N] float32 sampling weights: 1 for a valid row, 0 for another, and
    1 everywhere when no row is valid."""
    if valid.dtype != torch.bool or valid.ndim != 1:
        raise ValueError(f"homography weights: valid must be [N] bool, not "
                         f"{valid.dtype} {tuple(valid.shape)}")
    _device(valid)
    valid = valid.contiguous()
    p = torch.empty(valid.shape, dtype=torch.float32, device=valid.device)
    with torch.cuda.device(valid.device):
        err = _build.library().cusift_homography_weights(
            valid.data_ptr(), valid.shape[0], p.data_ptr(), _stream(valid))
    _build.check(err, "cusift_homography_weights")
    trace.count("kernel.homography")
    return p


def score(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor,
          thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(hs [HYP, 3, 3] float32, counts [HYP] int32): the homography of each
    sample idx [HYP, 4] (int64 rows of pa, pb) and its inliers (squared
    transfer error below thresh^2, valid rows only) over all N rows; -1
    for a hypothesis that is not finite, NaN for a sample with a row
    outside [0, N)."""
    pa, pb, valid = _rows(pa, pb, valid)
    if idx.dtype != torch.int64 or idx.ndim != 2 or idx.shape[1] != 4:
        raise ValueError(f"homography score: idx must be [HYP, 4] int64, not "
                         f"{idx.dtype} {tuple(idx.shape)}")
    _device(pa, idx)
    nhyp = idx.shape[0]
    if nhyp >= 2 ** 31:
        raise ValueError(f"homography score: {nhyp} hypotheses exceed int32")
    idx = idx.contiguous()
    hs = torch.empty((nhyp, 3, 3), dtype=torch.float32, device=pa.device)
    counts = torch.empty((nhyp,), dtype=torch.int32, device=pa.device)
    with torch.cuda.device(pa.device):
        err = _build.library().cusift_homography_score(
            pa.data_ptr(), pb.data_ptr(), valid.data_ptr(), pa.shape[0], idx.data_ptr(),
            nhyp, float(thresh) ** 2, hs.data_ptr(), counts.data_ptr(), _stream(pa))
    _build.check(err, "cusift_homography_score")
    trace.count("kernel.homography")
    return hs, counts


def refine(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor, thresh: float,
           iters: int, min_matches: int = 0, *, hs: torch.Tensor | None = None,
           counts: torch.Tensor | None = None, h: torch.Tensor | None = None):
    """`iters` IRLS rounds from the winner of `score` (hs, counts: the first
    of the largest counts) or from h [3, 3], and the result as
    `find_homography` returns it: (h [3, 3], inliers [N] bool, num_inliers
    int64, ok bool)."""
    pa, pb, valid = _rows(pa, pb, valid)
    if iters < 0:
        raise ValueError(f"homography refine: {iters} rounds")
    if (h is None) == (counts is None) or (counts is None) != (hs is None):
        raise ValueError("homography refine: give hs and counts, or h")
    if h is not None:
        if h.dtype != torch.float32 or h.shape != (3, 3):
            raise ValueError(f"homography refine: h must be [3, 3] float32, not "
                             f"{h.dtype} {tuple(h.shape)}")
        _device(pa, h)
        h = h.contiguous()
        nhyp = 0
    else:
        nhyp = counts.shape[0] if counts.ndim == 1 else -1
        if (counts.dtype != torch.int32 or hs.dtype != torch.float32 or nhyp <= 0
                or hs.shape != (nhyp, 3, 3)):
            raise ValueError(f"homography refine: hs {hs.dtype} {tuple(hs.shape)}, counts "
                             f"{counts.dtype} {tuple(counts.shape)}: want [HYP, 3, 3] "
                             "float32 and [HYP] int32, HYP > 0")
        _device(pa, hs, counts)
        hs, counts = hs.contiguous(), counts.contiguous()
    dev = pa.device
    out = (torch.empty((3, 3), dtype=torch.float32, device=dev),
           torch.empty(valid.shape, dtype=torch.bool, device=dev),
           torch.empty((), dtype=torch.int64, device=dev),
           torch.empty((), dtype=torch.bool, device=dev))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _build.library().cusift_homography_refine(
            pa.data_ptr(), pb.data_ptr(), valid.data_ptr(), pa.shape[0], ptr(hs),
            ptr(counts), nhyp, ptr(h), float(thresh) ** 2, iters, min_matches,
            *(t.data_ptr() for t in out), _stream(pa))
    _build.check(err, "cusift_homography_refine")
    trace.count("kernel.homography")
    return out

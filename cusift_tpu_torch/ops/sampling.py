"""Batched bilinear sampling (twin of `cusift_tpu/ops/sampling.py`).

`bilinear_sample` samples one channel of a level stack.  Every function
takes the stack's leading frame axes ([B, L, H, W] with [B, K, ...]
points), as `extract_batch` gives them.

`sample_grad_pair` takes kernel K1 (`kernels/sampler.py`) for every method
but "xla", which selects the plain version (gradient planes + a 4-corner
gather) on any device, as in the reference.  The reference's "fused" and
"separable" reach its XLA gather here; K1 computes the same function.
`sample_grad_grid` takes kernel K6 for "separable".  A kernel wrapper
launches its CUDA kernel for a CUDA tensor and takes its plain version
for a CPU tensor.
"""

from __future__ import annotations

import torch

from ..kernels import sampler as k
from ..kernels.sampler import bilinear_sample_pair

__all__ = ["bilinear_sample", "bilinear_sample_pair", "sample_grad_pair",
           "sample_grad_grid"]

METHODS = ("auto", "pallas", "fused", "separable", "xla")


def bilinear_sample(stack: torch.Tensor, lvl: torch.Tensor,
                    ys: torch.Tensor, xs: torch.Tensor):
    """Sample stack [..., L, H, W] at float (ys, xs) [..., K, S] on per-item
    integer levels lvl [..., K], the leading (frame) axes shared.

    Returns (values [..., K, S], in_bounds [..., K, S]).  Points outside the
    image take the clamped border's value; callers zero them by the mask.
    A level indexes its own frame's stack as the reference's gather does:
    a negative one counts from the end, and the index is clipped.
    """
    h, w = stack.shape[-2:]
    inb = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    ys = ys.clamp(0.0, h - 1.000001)
    xs = xs.clamp(0.0, w - 1.000001)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    fy = ys - y0
    fx = xs - x0
    flat = stack.reshape(-1, h, w)
    nlev = stack.shape[-3]
    lvl = lvl.to(torch.int64)
    li = k._planes(torch.where(lvl < 0, lvl + nlev, lvl), nlev)[..., None]
    top = flat[li, y0, x0] * (1 - fx) + flat[li, y0, x1] * fx
    bot = flat[li, y1, x0] * (1 - fx) + flat[li, y1, x1] * fx
    return top * (1 - fy) + bot * fy, inb


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown sampler {method!r}")


def sample_grad_pair(gauss: torch.Tensor, lvl: torch.Tensor,
                     ys: torch.Tensor, xs: torch.Tensor, *,
                     method: str = "auto"):
    """Bilinear-sample image gradients of `gauss` at per-slot float coords.

    gauss: [B, L, H, W] blurred levels; lvl: [B, K] int32; ys, xs:
    [B, K, S] f32 (or the unbatched [L, H, W], [K], [K, S]).  Returns (dx,
    dy, in_bounds), each shaped as ys.
    """
    _check_method(method)
    if method == "xla":
        return k.sample_grad_patches_plain(gauss, lvl, ys, xs)
    return k.sample_grad_patches(gauss.contiguous(), lvl.to(torch.int32).contiguous(),
                                 ys.contiguous(), xs.contiguous())


def sample_grad_grid(gauss: torch.Tensor, lvl: torch.Tensor,
                     ys_rows: torch.Tensor, xs_cols: torch.Tensor, *,
                     method: str = "auto"):
    """Gradient sampling on an axis-aligned per-slot grid.

    ys_rows [..., K, GR] and xs_cols [..., K, GC] define the grid, with
    gauss's leading axes; returns (dx, dy, inb) shaped [..., K, GR*GC] in
    row-major order.
    """
    _check_method(method)
    if method == "separable":
        return k.sample_grad_patches_sep(
            gauss.contiguous(), lvl.to(torch.int32).contiguous(),
            ys_rows.contiguous(), xs_cols.contiguous())
    return sample_grad_pair(gauss, lvl, *k._grid(ys_rows, xs_cols), method=method)

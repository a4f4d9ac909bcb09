"""Batched-hypothesis RANSAC homography (twin of the homography part of
`cusift_tpu/ops/ransac.py`).

A static batch of minimal samples is solved at once (a leading batch
dimension replaces the reference's `vmap`), scored as one [HYP, N]
broadcast, and the winner is polished by IRLS on its inliers.  Random
samples come from a `torch.Generator`; with none, one is seeded from
`cfg.seed`.  Torch cannot reproduce jax's threefry stream, so the tests
hold this module on outcomes, or feed both packages the same indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RansacConfig
from ..utils.precision import pin_f32
from .geometry import apply_homography, solve_homography


class HomographyResult(NamedTuple):
    h: torch.Tensor            # [3, 3]
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # int
    ok: torch.Tensor           # bool: enough matches / valid fit


def _sample_indices(gen: torch.Generator, valid: torch.Tensor, nhyp: int,
                    k: int) -> torch.Tensor:
    """[nhyp, k] indices drawn with replacement from the valid set.

    With no valid entry the draw is uniform (`torch.multinomial` refuses
    an all-zero p); `ok` gates that result off anyway.
    """
    p = valid.to(torch.float32).to(gen.device)
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    idx = torch.multinomial(p, nhyp * k, replacement=True, generator=gen)
    return idx.reshape(nhyp, k).to(valid.device)


def _irls(h, pa, pb, valid, thresh: float, iters: int):
    """Repeated inlier re-selection under h + weighted DLT solve."""
    for _ in range(iters):
        err = ((apply_homography(h, pa) - pb) ** 2).sum(-1)
        w = ((err < thresh ** 2) & valid).to(torch.float32)
        h2 = solve_homography(pa, pb, w)
        # < 4 inliers under-determines H; keep the previous estimate
        good = torch.isfinite(h2).all() & (w.sum() >= 4)
        h = torch.where(good, h2, h)
    return h


def find_homography(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
                    cfg: RansacConfig = RansacConfig(),
                    generator: torch.Generator | None = None) -> HomographyResult:
    """RANSAC homography pa -> pb over [N, 2] correspondences + mask."""
    pin_f32()
    if generator is None:
        generator = torch.Generator(device=pa.device).manual_seed(cfg.seed)
    idx = _sample_indices(generator, valid, cfg.num_hypotheses, 4)
    # the 4 sampled points with unit weights == one-hot weights over all N
    # (a repeated index counts twice in both), without the [HYP, N] solve
    ones = torch.ones(idx.shape, dtype=pa.dtype, device=pa.device)
    hs = solve_homography(pa[idx], pb[idx], ones)              # [HYP, 3, 3]
    finite = torch.isfinite(hs.reshape(hs.shape[0], -1)).all(-1)

    err = ((apply_homography(hs, pa) - pb) ** 2).sum(-1)       # [HYP, N]
    counts = ((err < cfg.inlier_thresh ** 2) & valid).sum(-1)
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    h = hs[torch.argmax(counts)]

    h = _irls(h, pa, pb, valid, cfg.inlier_thresh, cfg.refine_iters)
    err = ((apply_homography(h, pa) - pb) ** 2).sum(-1)
    inliers = (err < cfg.inlier_thresh ** 2) & valid
    num = inliers.sum()
    ok = (valid.sum() >= cfg.min_matches) & (num >= 4)
    return HomographyResult(h=h, inliers=inliers, num_inliers=num, ok=ok)


def improve_homography(h: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                       valid: torch.Tensor, thresh: float = 3.0,
                       iters: int = 5) -> torch.Tensor:
    """Standalone IRLS polish of an existing homography (a tracker's
    prediction, for example); `find_homography` runs the same loop."""
    pin_f32()
    return _irls(h, pa, pb, valid, thresh, iters)

"""Batched-hypothesis RANSAC: homography and 3-D rigid transform (twin of
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
from ..utils.precision import f32_matmuls, pin_f32
from .geometry import apply_homography, procrustes, solve_homography


class HomographyResult(NamedTuple):
    h: torch.Tensor            # [3, 3]
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # int
    ok: torch.Tensor           # bool: enough matches / valid fit


class RigidResult(NamedTuple):
    r: torch.Tensor            # [3, 3]
    t: torch.Tensor            # [3]
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # int
    ok: torch.Tensor           # bool


def step_generators(device, seed: int, counter: int, n: int = 1) -> list[torch.Generator]:
    """n generators for one step's RANSAC calls, seeded from (seed,
    counter) where the reference derives one threefry key per step and
    splits it n ways.  The seed's high word is `seed`; its low word mixes
    the seed into the counter (the CPU generator keeps only the low 32
    bits of its seed) and the child index.  Seed 0, child 0 gives the
    counter itself."""
    s = seed & 0xFFFFFFFF
    low = (counter + s * 0x9E3779B9) & 0xFFFFFFFF
    return [torch.Generator(device=device).manual_seed(
        (s << 32) | ((low + c * 0x632BE5AB) & 0xFFFFFFFF)) for c in range(n)]


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


def _rigid_sq_err(r, t, pa, pb):
    """[..., N] squared 3-D residuals of pb ~ R pa + t for [..., 3, 3] R."""
    return ((pa @ r.transpose(-1, -2) + t[..., None, :] - pb) ** 2).sum(-1)


@f32_matmuls
def find_rigid(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
               cfg: RansacConfig = RansacConfig(),
               generator: torch.Generator | None = None) -> RigidResult:
    """RANSAC rigid transform (R, t) with R @ pa + t ~ pb on [N, 3] points.

    The RGB-D alignment of cuSIFT: 3-point Procrustes hypotheses, the
    `inlier_thresh_3d` gate, and `refine_iters` weighted Procrustes rounds
    on the winner's inliers.
    """
    if generator is None:
        generator = torch.Generator(device=pa.device).manual_seed(cfg.seed)
    idx = _sample_indices(generator, valid, cfg.num_hypotheses, 3)
    # the 3 sampled points with unit weights == one-hot weights over all N
    ones = torch.ones(idx.shape, dtype=pa.dtype, device=pa.device)
    rs, ts = procrustes(pa[idx], pb[idx], ones)              # [HYP, 3, 3], [HYP, 3]
    thr = cfg.inlier_thresh_3d ** 2
    finite = torch.isfinite(rs.reshape(rs.shape[0], -1)).all(-1)
    counts = ((_rigid_sq_err(rs, ts, pa, pb) < thr) & valid).sum(-1)
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts)
    r, t = rs[best], ts[best]
    for _ in range(cfg.refine_iters):
        w = ((_rigid_sq_err(r, t, pa, pb) < thr) & valid).to(pa.dtype)
        r2, t2 = procrustes(pa, pb, w)
        good = (torch.isfinite(r2).all() & torch.isfinite(t2).all()
                & (w.sum() >= 3))
        r, t = torch.where(good, r2, r), torch.where(good, t2, t)
    inliers = (_rigid_sq_err(r, t, pa, pb) < thr) & valid
    num = inliers.sum()
    ok = (valid.sum() >= cfg.min_matches) & (num >= 3)
    return RigidResult(r=r, t=t, inliers=inliers, num_inliers=num, ok=ok)

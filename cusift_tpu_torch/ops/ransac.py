"""Batched-hypothesis RANSAC: homography and 3-D rigid transform (twin of
`cusift_tpu/ops/ransac.py`).

A static batch of minimal samples is solved at once (a leading batch
dimension replaces the reference's `vmap`), scored as one [HYP, N]
broadcast, and the winner is polished by IRLS on its inliers.  Random
samples come from a `torch.Generator`; with none, one is seeded from
`cfg.seed`.  Torch cannot reproduce jax's threefry stream, so the tests
hold this module on outcomes, or feed both packages the same indices.

On a CUDA tensor `find_homography` and `improve_homography` run as three
CUDA kernels (`kernels/homography.py`): the sampling weights, the minimal
solves with their inlier counts, and the IRLS polish with the result.
The draws stay `torch.multinomial`'s, from the caller's generator.  The
torch code here is their plain version, taken for CPU tensors only.

`find_rigid` also takes a leading frame axis with one generator a frame,
which replaces the reference's `jax.vmap(find_rigid)` in the tracking
chunk: each frame draws its hypotheses from its own generator, and the
solves, scoring and IRLS rounds run once for the batch, in an order that
makes frame b equal the frame alone, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RansacConfig
from ..kernels import homography as kh
from ..utils import trace
from ..utils.precision import f32_matmuls, pin_f32
from .geometry import apply_homography, procrustes, solve_homography


class HomographyResult(NamedTuple):
    h: torch.Tensor            # [3, 3]
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # int
    ok: torch.Tensor           # bool: enough matches / valid fit


class RigidResult(NamedTuple):
    """One fit, or [B, ...] for a batch of frames."""

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
    return _draw(gen, p, nhyp, k).to(valid.device)


def _draw(gen: torch.Generator, p: torch.Tensor, nhyp: int, k: int) -> torch.Tensor:
    """[nhyp, k] indices drawn with replacement by the weights p [N]."""
    idx = torch.multinomial(p, nhyp * k, replacement=True, generator=gen)
    return idx.reshape(nhyp, k)


def _hypotheses(pa, pb, idx):
    """[HYP, 3, 3] minimal homographies of the samples idx [HYP, 4]: the 4
    sampled points with unit weights, which equals one-hot weights over
    all N (a repeated index counts twice in both) without the [HYP, N]
    solve."""
    ones = torch.ones(idx.shape, dtype=pa.dtype, device=pa.device)
    return solve_homography(pa[idx], pb[idx], ones)


def _scores(hs, pa, pb, valid, thresh: float):
    """[HYP] inliers of each hypothesis over the valid rows, -1 where it is
    not finite."""
    finite = torch.isfinite(hs.reshape(hs.shape[0], -1)).all(-1)
    err = ((apply_homography(hs, pa) - pb) ** 2).sum(-1)       # [HYP, N]
    counts = ((err < thresh ** 2) & valid).sum(-1)
    return torch.where(finite, counts, torch.full_like(counts, -1))


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


def _refine(h, pa, pb, valid, thresh: float, iters: int,
            min_matches: int) -> HomographyResult:
    """The IRLS polish of h and the result it gives."""
    h = _irls(h, pa, pb, valid, thresh, iters)
    err = ((apply_homography(h, pa) - pb) ** 2).sum(-1)
    inliers = (err < thresh ** 2) & valid
    num = inliers.sum()
    ok = (valid.sum() >= min_matches) & (num >= 4)
    return HomographyResult(h=h, inliers=inliers, num_inliers=num, ok=ok)


def find_homography(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
                    cfg: RansacConfig = RansacConfig(),
                    generator: torch.Generator | None = None) -> HomographyResult:
    """RANSAC homography pa -> pb over [N, 2] correspondences + mask."""
    with trace.span("ransac.homography", frames=1):
        trace.count("ransac.frames")
        return _find_homography(pa, pb, valid, cfg, generator)


def _find_homography(pa, pb, valid, cfg: RansacConfig, generator) -> HomographyResult:
    pin_f32()
    if generator is None:
        generator = torch.Generator(device=pa.device).manual_seed(cfg.seed)
    thresh, nhyp = cfg.inlier_thresh, cfg.num_hypotheses
    if pa.device.type != "cpu":
        # the kernels, on the plain version's draws
        p = kh.weights(valid).to(generator.device)
        idx = _draw(generator, p, nhyp, 4).to(pa.device)
        hs, counts = kh.score(pa, pb, valid, idx, thresh)
        return HomographyResult(*kh.refine(pa, pb, valid, thresh, cfg.refine_iters,
                                           cfg.min_matches, hs=hs, counts=counts))
    idx = _sample_indices(generator, valid, nhyp, 4)
    hs = _hypotheses(pa, pb, idx)
    counts = _scores(hs, pa, pb, valid, thresh)
    return _refine(hs[torch.argmax(counts)], pa, pb, valid, thresh, cfg.refine_iters,
                   cfg.min_matches)


def improve_homography(h: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                       valid: torch.Tensor, thresh: float = 3.0,
                       iters: int = 5) -> torch.Tensor:
    """Standalone IRLS polish of an existing homography (a tracker's
    prediction, for example); `find_homography` runs the same loop."""
    pin_f32()
    if pa.device.type != "cpu":
        return kh.refine(pa, pb, valid, thresh, iters, h=h)[0]
    return _irls(h, pa, pb, valid, thresh, iters)


def _rigid_sq_err(r, t, pa, pb):
    """[..., N] squared 3-D residuals of pb ~ R pa + t for [..., 3, 3] R and
    [..., 3] t (broadcast against pa, pb [..., N, 3]), a coordinate at a
    time: each a product summed over 3 contiguous terms, whose order does
    not move with the batch around a frame (a batched matmul's does), in
    the [..., HYP, N, 3] width of one product."""
    sq = [((pa * r[..., c, None, :]).sum(-1) + t[..., c, None] - pb[..., c]) ** 2
          for c in range(3)]
    return sq[0] + sq[1] + sq[2]


@f32_matmuls
def find_rigid(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
               cfg: RansacConfig = RansacConfig(),
               generator=None) -> RigidResult:
    """RANSAC rigid transform (R, t) with R @ pa + t ~ pb on [N, 3] points.

    The RGB-D alignment of cuSIFT: 3-point Procrustes hypotheses, the
    `inlier_thresh_3d` gate, and `refine_iters` weighted Procrustes rounds
    on the winner's inliers.  pa, pb [B, N, 3] and valid [B, N] fit B
    frames at once, with `generator` a sequence of B generators (frame b
    draws from generator b, as the frame alone would); the result carries
    the B axis.
    """
    frames = pa.shape[0] if pa.ndim == 3 else 1
    with trace.span("ransac.rigid", frames=frames):
        trace.count("ransac.frames", frames)
        return _find_rigid(pa, pb, valid, cfg, generator)


def _find_rigid(pa, pb, valid, cfg: RansacConfig, generator) -> RigidResult:
    batched = pa.ndim == 3
    if not batched:
        pa, pb, valid = pa[None], pb[None], valid[None]
        generator = [generator]
    gens = [torch.Generator(device=pa.device).manual_seed(cfg.seed) if g is None else g
            for g in generator]
    if len(gens) != pa.shape[0]:
        raise ValueError(f"find_rigid: {len(gens)} generators for {pa.shape[0]} frames")
    # each frame's draws from its own generator (the reference splits one
    # key a frame), then every solve once for the batch
    idx = torch.stack([_sample_indices(g, v, cfg.num_hypotheses, 3)
                       for g, v in zip(gens, valid)])            # [B, HYP, 3]
    frames = torch.arange(pa.shape[0], device=pa.device)
    # the 3 sampled points with unit weights == one-hot weights over all N
    ones = torch.ones(idx.shape, dtype=pa.dtype, device=pa.device)
    rs, ts = procrustes(pa[frames[:, None, None], idx],
                        pb[frames[:, None, None], idx], ones)    # [B, HYP, 3, 3], [B, HYP, 3]
    thr = cfg.inlier_thresh_3d ** 2
    finite = torch.isfinite(rs.flatten(-2)).all(-1)
    counts = ((_rigid_sq_err(rs, ts, pa[:, None], pb[:, None]) < thr)
              & valid[:, None]).sum(-1)                          # [B, HYP]
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts, -1)
    r, t = rs[frames, best], ts[frames, best]
    for _ in range(cfg.refine_iters):
        w = ((_rigid_sq_err(r, t, pa, pb) < thr) & valid).to(pa.dtype)
        r2, t2 = procrustes(pa, pb, w)
        good = (torch.isfinite(r2).flatten(-2).all(-1) & torch.isfinite(t2).all(-1)
                & (w.sum(-1) >= 3))
        r, t = torch.where(good[:, None, None], r2, r), torch.where(good[:, None], t2, t)
    inliers = (_rigid_sq_err(r, t, pa, pb) < thr) & valid
    num = inliers.sum(-1)
    ok = (valid.sum(-1) >= cfg.min_matches) & (num >= 3)
    res = RigidResult(r=r, t=t, inliers=inliers, num_inliers=num, ok=ok)
    return res if batched else RigidResult(*(x[0] for x in res))

"""DLT-PnP RANSAC: 3-D map landmarks -> camera pose at map scale (twin of
`cusift_tpu/ops/pnp.py`).

Non-minimal DLT hypotheses (the 12x12 normal-matrix null space by the
inverse power iteration of `ops/essential.py`), rotation from the
projective 3x4 by Horn's quaternion method (the nearest rotation), MSAC
scoring with a cheirality gate, an annealed IRLS refine, and an optional
prior pose in the hypothesis pool.  Hypotheses are a leading batch
dimension; each sample is its gathered points with unit weights.

`pts` are world-frame landmarks, `xy` NORMALISED camera coordinates; the
result is world-to-camera (x_cam = R x_w + t).  Thresholds are in
normalised units.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import RansacConfig
from ..utils.precision import f32_matmuls
from .essential import _null_vector, _ridge
from .geometry import normalise_points, rotation_from_cross_covariance
from .mat3 import inv3
from .ransac import _sample_indices


class PnPResult(NamedTuple):
    r: torch.Tensor            # [3, 3] world-to-camera rotation
    t: torch.Tensor            # [3] translation at MAP scale
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # int
    ok: torch.Tensor           # bool


def _normalise_points3(pts: torch.Tensor, w: torch.Tensor):
    """Hartley conditioning of [..., N, 3] points: centroid 0, mean
    distance sqrt(3).  Returns (normalised points, [..., 4, 4] T with
    X_n = T X_h)."""
    wsum = w.sum(-1).clamp(min=1e-12)
    c = (pts * w[..., None]).sum(-2) / wsum[..., None]            # [..., 3]
    d = torch.sqrt(((pts - c[..., None, :]) ** 2).sum(-1))
    s = math.sqrt(3.0) / ((d * w).sum(-1) / wsum).clamp(min=1e-12)
    t = torch.zeros(s.shape + (4, 4), dtype=pts.dtype, device=pts.device)
    for i in range(3):
        t[..., i, i] = s
        t[..., i, 3] = -s * c[..., i]
    t[..., 3, 3] = 1.0
    return (pts - c[..., None, :]) * s[..., None, None], t


def _dlt_rows(pts: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[..., 2N, 12] projective-DLT rows: row . vec(P) = 0 for x ~ P X."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    u, v = xy[..., 0], xy[..., 1]
    o = torch.ones_like(x)
    zr = torch.zeros_like(x)
    r1 = torch.stack([x, y, z, o, zr, zr, zr, zr, -u * x, -u * y, -u * z, -u], -1)
    r2 = torch.stack([zr, zr, zr, zr, x, y, z, o, -v * x, -v * y, -v * z, -v], -1)
    return torch.cat([r1, r2], -2)


@f32_matmuls
def solve_pnp(pts: torch.Tensor, xy: torch.Tensor, w: torch.Tensor):
    """Weighted DLT perspective-n-point from [..., N, 3] + [..., N, 2].

    Returns (r, t) with x_cam ~ R x_w + t (t at map scale).  Degenerate
    samples give garbage that RANSAC scoring discards.
    """
    ptsn, t3 = _normalise_points3(pts, w)
    xyn, t2 = normalise_points(xy, w)
    a = _dlt_rows(ptsn, xyn)                                      # [..., 2N, 12]
    ww = torch.cat([w, w], -1)
    ata = _ridge((a * ww[..., None]).transpose(-1, -2) @ a)
    pn = _null_vector(ata).reshape(ata.shape[:-2] + (3, 4))
    p = inv3(t2) @ pn @ t3                                        # denormalise
    # sign: the weighted points' depths must be positive
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    z = (ph * p[..., 2:3, :]).sum(-1)                             # [..., N]
    neg = (torch.sign(z) * w).sum(-1) < 0
    p = p * torch.where(neg, -1.0, 1.0).to(p.dtype)[..., None, None]
    m = p[..., :3]
    r = rotation_from_cross_covariance(m.transpose(-1, -2))       # nearest rotation
    s = (r * m).sum((-1, -2)) / 3.0                               # tr(R^T M) / 3
    s = torch.where(s.abs() > 1e-12, s, torch.full_like(s, 1e-12))
    return r, p[..., 3] / s[..., None]


def reprojection_error2(r: torch.Tensor, t: torch.Tensor, pts: torch.Tensor,
                        xy: torch.Tensor):
    """Squared normalised reprojection error [..., N] and camera-frame
    depth [..., N], for [..., 3, 3] R and [..., 3] t."""
    pc = pts @ r.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    sgn = torch.sign(torch.where(z == 0, torch.ones_like(z), z))
    proj = pc[..., :2] / z.abs().clamp(min=1e-9)[..., None] * sgn[..., None]
    return ((proj - xy) ** 2).sum(-1), z


def _msac_cost(r, t, pts, xy, valid, th2):
    """MSAC cost: truncated squared error, infinite behind the camera."""
    err, z = reprojection_error2(r, t, pts, xy)
    e = torch.where(z > 1e-6, err, torch.full_like(err, torch.inf))
    return torch.where(valid, e.clamp(max=th2), torch.zeros_like(e)).sum(-1)


@f32_matmuls
def find_pnp(pts: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
             cfg: RansacConfig = RansacConfig(),
             generator: torch.Generator | None = None,
             init: tuple | None = None) -> PnPResult:
    """RANSAC PnP over [N, 3] world landmarks / [N, 2] normalised coords.

    num_hypotheses - 1 non-minimal samples of `pnp_sample_size` points,
    one solve over ALL valid correspondences, and the optional prior
    `init` = (r0, t0) make the pool; MSAC picks the winner; the IRLS
    re-solve threshold anneals 3x -> 1x, and the refined pose is kept only
    if it does not raise the MSAC cost.
    """
    if generator is None:
        generator = torch.Generator(device=pts.device).manual_seed(cfg.seed)
    idx = _sample_indices(generator, valid, cfg.num_hypotheses - 1, cfg.pnp_sample_size)
    ones = torch.ones(idx.shape, dtype=pts.dtype, device=pts.device)
    rs, ts = solve_pnp(pts[idx], xy[idx], ones)                  # [HYP-1, 3, 3]
    r_all, t_all = solve_pnp(pts, xy, valid.to(pts.dtype))
    rs, ts = [rs, r_all[None]], [ts, t_all[None]]
    if init is not None:
        rs.append(torch.as_tensor(init[0], dtype=pts.dtype, device=pts.device)[None])
        ts.append(torch.as_tensor(init[1], dtype=pts.dtype, device=pts.device)[None])
    rs, ts = torch.cat(rs), torch.cat(ts)
    finite = (torch.isfinite(rs.reshape(rs.shape[0], -1)).all(-1)
              & torch.isfinite(ts).all(-1))
    th2 = cfg.inlier_thresh_pnp ** 2
    costs = _msac_cost(rs, ts, pts, xy, valid, th2)
    costs = torch.where(finite, costs, torch.full_like(costs, torch.inf))
    best = torch.argmin(costs)
    r, t = rs[best], ts[best]
    r0, t0 = r, t
    for f in torch.linspace(3.0, 1.0, max(cfg.refine_iters, 2)).tolist():
        err, z = reprojection_error2(r, t, pts, xy)
        w = ((err < f * f * th2) & (z > 1e-6) & valid).to(pts.dtype)
        r2, t2 = solve_pnp(pts, xy, w)
        good = torch.isfinite(r2).all() & torch.isfinite(t2).all() & (w.sum() >= 6)
        r, t = torch.where(good, r2, r), torch.where(good, t2, t)
    worse = _msac_cost(r, t, pts, xy, valid, th2) > costs[best]
    r, t = torch.where(worse, r0, r), torch.where(worse, t0, t)
    err, z = reprojection_error2(r, t, pts, xy)
    inliers = (err < th2) & (z > 1e-6) & valid
    num = inliers.sum()
    ok = (valid.sum() >= cfg.min_matches) & (num >= 6)
    return PnPResult(r=r, t=t, inliers=inliers, num_inliers=num, ok=ok)

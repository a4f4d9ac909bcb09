"""Essential-matrix RANSAC and two-view monocular geometry (twin of
`cusift_tpu/ops/essential.py`).

Normalised 8-point hypotheses solved all at once (a leading batch
dimension over the hypotheses replaces the reference's `vmap`; each
minimal sample is its 8 gathered points with unit weights, which equals
one-hot weights over all N), Sampson-error scoring as one [HYP, N]
broadcast, IRLS on the winner's inliers, and a closed-form decomposition
into (R, t) with a cheirality vote over the four candidates.  The 9x9
null space is an inverse power iteration on the ridge-regularised normal
matrix through the unrolled Cholesky (`ops/mat3.py:solve_spd`); the one
true SVD, of the winner only, is `torch.linalg.svd` in float32.

All coordinates are NORMALISED camera coordinates (pixels through K^-1);
thresholds are in normalised units.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RansacConfig
from ..utils.precision import f32_matmuls
from .geometry import normalise_points
from .mat3 import det3, solve_spd
from .ransac import _sample_indices


class EssentialResult(NamedTuple):
    e: torch.Tensor            # [3, 3] essential matrix (xb^T E xa = 0)
    r: torch.Tensor            # [3, 3] rotation with xb ~ R xa + t
    t: torch.Tensor            # [3] unit-norm translation (scale-free)
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # int
    ok: torch.Tensor           # bool


def _essential_rows(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """[..., N, 9] epipolar-constraint rows: row . vec(E) = xb^T E xa."""
    ax, ay = xa[..., 0], xa[..., 1]
    bx, by = xb[..., 0], xb[..., 1]
    o = torch.ones_like(ax)
    return torch.stack([bx * ax, bx * ay, bx, by * ax, by * ay, by, ax, ay, o], -1)


def _null_vector(ata: torch.Tensor) -> torch.Tensor:
    """Least eigenvector of [..., n, n] SPD normal matrices: 4 rounds of
    inverse power iteration from a fixed full-rank start, keeping the
    previous iterate wherever a solve degenerates."""
    v = torch.full(ata.shape[:-1], 1.0 / 3.0, dtype=ata.dtype, device=ata.device)
    for _ in range(4):
        v2 = solve_spd(ata, v)
        nrm = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
        good = torch.isfinite(nrm) & (nrm > 1e-20)
        v = torch.where(good, v2 / torch.where(good, nrm, torch.ones_like(nrm)), v)
    return v


def _ridge(ata: torch.Tensor) -> torch.Tensor:
    """ata + 1e-6 trace(ata) I: f32 headroom for a minimal sample's
    near-singular Cholesky."""
    n = ata.shape[-1]
    tr = torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1)
    return ata + 1e-6 * tr[..., None, None] * torch.eye(n, dtype=ata.dtype, device=ata.device)


@f32_matmuls
def solve_essential(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point essential matrix from [..., N, 2] normalised coords.

    Hartley-normalises both sides, forms the 9x9 normal matrix of the
    epipolar rows and takes its least eigenvector (`_null_vector`).
    Degenerate samples give garbage that RANSAC scoring discards.
    """
    xan, ta = normalise_points(xa, w)
    xbn, tb = normalise_points(xb, w)
    a = _essential_rows(xan, xbn)                                 # [..., N, 9]
    ata = _ridge((a * w[..., None]).transpose(-1, -2) @ a)
    en = _null_vector(ata).reshape(ata.shape[:-2] + (3, 3))
    e = tb.transpose(-1, -2) @ en @ ta                            # denormalise
    nrm = torch.linalg.matrix_norm(e)[..., None, None]
    return e / nrm.clamp(min=1e-20)


def sampson_error(e: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) epipolar error, [..., N] for
    [..., 3, 3] E."""
    pa = torch.cat([xa, torch.ones_like(xa[..., :1])], -1)        # [N, 3]
    pb = torch.cat([xb, torch.ones_like(xb[..., :1])], -1)
    ea = pa @ e.transpose(-1, -2)                                 # E xa
    eb = pb @ e                                                   # E^T xb
    num = (pb * ea).sum(-1) ** 2
    den = ea[..., 0] ** 2 + ea[..., 1] ** 2 + eb[..., 0] ** 2 + eb[..., 1] ** 2
    return num / den.clamp(min=1e-18)


@f32_matmuls
def triangulate_midpoint(r: torch.Tensor, t: torch.Tensor, xa: torch.Tensor,
                         xb: torch.Tensor):
    """Midpoint triangulation for xb ~ R xa + t ([..., 3, 3] R, [..., 3] t).

    Rays: camera A at the origin along (xa, 1); camera B's centre in the
    A frame is c = -R^T t, along R^T (xb, 1).  Minimising
    ||za da - (c + zb db)||^2 is a closed-form 2x2 solve per point.
    Returns (points [..., N, 3] in the A frame, depth_a, depth_b [..., N]).
    """
    da = torch.cat([xa, torch.ones_like(xa[..., :1])], -1)
    db = torch.cat([xb, torch.ones_like(xb[..., :1])], -1) @ r    # R^T rows
    c = -(r.transpose(-1, -2) @ t[..., None])[..., 0]             # [..., 3]
    daa = (da * da).sum(-1)
    dbb = (db * db).sum(-1)
    dab = (da * db).sum(-1)
    dac = (da * c[..., None, :]).sum(-1)
    dbc = (db * c[..., None, :]).sum(-1)
    det = daa * dbb - dab * dab
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    za = (dac * dbb - dbc * dab) / det
    zb = (dac * dab - dbc * daa) / det
    pts = 0.5 * (za[..., None] * da + c[..., None, :] + zb[..., None] * db)
    return pts, za, zb


@f32_matmuls
def decompose_essential(e: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                        w: torch.Tensor):
    """(R, t) from E with a cheirality vote over the four candidates.

    One float32 `torch.linalg.svd` of the 3x3 winner, with the
    reference's determinant sign fix on U and V^T.  Returns (r, t, n_good),
    n_good the winning candidate's count of weighted correspondences in
    front of BOTH cameras.
    """
    u, _, vt = torch.linalg.svd(e.to(torch.float32))
    u = u * torch.sign(det3(u))
    vt = vt * torch.sign(det3(vt))
    wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=u.dtype, device=u.device)
    r1 = u @ wm @ vt
    r2 = u @ wm.T @ vt
    tu = u[:, 2]
    rs = torch.stack([r1, r1, r2, r2])
    ts = torch.stack([tu, -tu, tu, -tu])
    _, za, zb = triangulate_midpoint(rs, ts, xa, xb)              # [4, N]
    counts = ((w > 0) & (za > 1e-6) & (zb > 1e-6)).sum(-1)
    best = torch.argmax(counts)
    return rs[best], ts[best], counts[best]


def _inlier_mask(e, xa, xb, valid, th2):
    return (sampson_error(e, xa, xb) < th2) & valid


@f32_matmuls
def find_essential(xa: torch.Tensor, xb: torch.Tensor, valid: torch.Tensor,
                   cfg: RansacConfig = RansacConfig(),
                   generator: torch.Generator | None = None) -> EssentialResult:
    """RANSAC essential matrix over [N, 2] normalised correspondences.

    Hypotheses -> batched solves -> broadcast scoring -> IRLS polish ->
    decomposition with the cheirality vote.  `generator` draws the
    samples (seeded from cfg.seed when None).
    """
    if generator is None:
        generator = torch.Generator(device=xa.device).manual_seed(cfg.seed)
    idx = _sample_indices(generator, valid, cfg.num_hypotheses, 8)
    ones = torch.ones(idx.shape, dtype=xa.dtype, device=xa.device)
    es = solve_essential(xa[idx], xb[idx], ones)                  # [HYP, 3, 3]
    flat = es.reshape(es.shape[0], -1)
    # reject non-finite AND near-zero hypotheses: E = 0 makes the Sampson
    # numerator vacuously zero for every correspondence
    finite = torch.isfinite(flat).all(-1) & (torch.linalg.vector_norm(flat, dim=-1) > 0.5)
    th2 = cfg.inlier_thresh_epi ** 2
    counts = _inlier_mask(es, xa, xb, valid, th2).sum(-1)         # [HYP]
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    e = es[torch.argmax(counts)]
    for _ in range(cfg.refine_iters):
        w = _inlier_mask(e, xa, xb, valid, th2).to(xa.dtype)
        e2 = solve_essential(xa, xb, w)
        good = (torch.isfinite(e2).all() & (torch.linalg.matrix_norm(e2) > 0.5)
                & (w.sum() >= 8))
        e = torch.where(good, e2, e)
    inliers = _inlier_mask(e, xa, xb, valid, th2)
    num = inliers.sum()
    r, t, n_good = decompose_essential(e, xa, xb, inliers.to(xa.dtype))
    ok = (valid.sum() >= cfg.min_matches) & (num >= 8) & (n_good >= num // 2)
    return EssentialResult(e=e, r=r, t=t, inliers=inliers, num_inliers=num, ok=ok)

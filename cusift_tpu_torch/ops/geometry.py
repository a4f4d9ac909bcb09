"""Geometry primitives: homographies, Procrustes, pinhole projection
(twin of `cusift_tpu/ops/geometry.py`).

Every solver broadcasts over leading batch dimensions, which replaces the
reference's `vmap` over RANSAC hypotheses: pts [..., N, 2|3] and weights
[..., N] (either may carry the batch).  `procrustes` and
`rotation_from_cross_covariance` also carry the frame axis of the tracking
chunk, so they sum and multiply in an order that does not depend on the
leading axes (`mat3.tree_sum`, `mat3.matmul_small`): frame b of a batch
equals the frame alone, bit for bit.
"""

from __future__ import annotations

import math

import torch

from ..utils.precision import f32_matmuls
from .mat3 import inv3, matmul_small, solve_spd, tree_sum


@f32_matmuls
def apply_homography(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Map [..., N, 2] points through [..., 3, 3] homographies."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    q = p @ h.transpose(-1, -2)
    z = q[..., 2:]
    return q[..., :2] / torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))


@f32_matmuls
def masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of vals[mask] over the last axis: +inf-padded sort and the
    lower middle index (static shape); +inf when the mask is empty."""
    n = vals.shape[-1]
    cnt = mask.to(torch.int64).sum(-1, keepdim=True)
    s = torch.sort(torch.where(mask, vals, torch.full_like(vals, torch.inf)), -1).values
    mid = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, n - 1)
    return torch.gather(s, -1, mid)[..., 0]


@f32_matmuls
def normalise_points(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalisation: zero-mean, mean length sqrt(2); weighted.

    Returns (normalised points [..., N, 2], T [..., 3, 3]) with
    p_norm = T @ p.
    """
    wsum = w.sum(-1).clamp(min=1e-12)                          # [...]
    c = (pts * w[..., None]).sum(-2) / wsum[..., None]         # [..., 2]
    d = torch.sqrt(((pts - c[..., None, :]) ** 2).sum(-1))     # [..., N]
    mean_d = (d * w).sum(-1) / wsum
    s = math.sqrt(2.0) / mean_d.clamp(min=1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    t = torch.stack([torch.stack([s, zero, -s * c[..., 0]], -1),
                     torch.stack([zero, s, -s * c[..., 1]], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    return (pts - c[..., None, :]) * s[..., None, None], t


def homography_rows(pa: torch.Tensor, pb: torch.Tensor):
    """DLT rows with h33 := 1: A [..., 2N, 8], b [..., 2N], A h8 = b."""
    xa, ya = pa[..., 0], pa[..., 1]
    xb, yb = pb[..., 0], pb[..., 1]
    z = torch.zeros_like(xa)
    o = torch.ones_like(xa)
    rx = torch.stack([xa, ya, o, z, z, z, -xb * xa, -xb * ya], -1)
    ry = torch.stack([z, z, z, xa, ya, o, -yb * xa, -yb * ya], -1)
    return torch.cat([rx, ry], -2), torch.cat([xb, yb], -1)


@f32_matmuls
def solve_homography(pa: torch.Tensor, pb: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares homography (h33=1 gauge) with normalisation.

    pa, pb: [..., N, 2]; w: [..., N] weights.  Minimal 4-point solves use
    one-hot weights, or the 4 sampled points with unit weights.
    """
    pan, ta = normalise_points(pa, w)
    pbn, tb = normalise_points(pb, w)
    a, b = homography_rows(pan, pbn)
    ww = torch.cat([w, w], -1)[..., None]                      # [..., 2N, 1]
    aw = (a * ww).transpose(-1, -2)                            # [..., 8, 2N]
    eye = torch.eye(8, dtype=a.dtype, device=a.device)
    ata = aw @ a + 1e-10 * eye
    atb = (aw @ b[..., None])[..., 0]
    h8 = solve_spd(ata, atb)     # unrolled Cholesky, elementwise over batch
    hn = torch.cat([h8, torch.ones_like(h8[..., :1])], -1)
    hn = hn.reshape(hn.shape[:-1] + (3, 3))
    h = inv3(tb) @ hn @ ta       # closed-form adjugate, no LU
    h22 = h[..., 2:, 2:]
    return h / torch.where(h22.abs() > 1e-12, h22, torch.full_like(h22, 1e-12))


@f32_matmuls
def procrustes(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor,
               iters: int = 16):
    """Weighted rigid fit R, t with R @ pa + t ~ pb (no scale).

    Horn's quaternion method: R comes from the principal eigenvector of a
    symmetric 4x4 built from the cross-covariance, found by an unrolled
    shifted power iteration -- elementwise tensor math over any batch of
    hypotheses, always a proper rotation.  pa, pb: [..., N, 3]; w: [..., N]
    non-negative weights.  The sums over the N points are pairwise trees
    (`tree_sum`), so a frame's fit does not depend on the batch around it.
    """
    pat, pbt = pa.transpose(-1, -2), pb.transpose(-1, -2)        # [..., 3, N]
    sums = tree_sum(torch.cat([w[..., None, :], pat * w[..., None, :],
                                pbt * w[..., None, :]], -2), -1)   # [..., 7]
    wsum = sums[..., :1].clamp(min=1e-12)
    ca, cb = sums[..., 1:4] / wsum, sums[..., 4:7] / wsum
    # Horn convention: S[i, j] = sum_n a_i b_j (A -> B rotation)
    da = (pat - ca[..., :, None]) * w[..., None, :]
    db = pbt - cb[..., :, None]
    s_ = tree_sum(da[..., :, None, :] * db[..., None, :, :], -1)   # [..., 3, 3]
    r = rotation_from_cross_covariance(s_, iters, fixed_order=True)
    return r, cb - matmul_small(r, ca[..., None])[..., 0]


@f32_matmuls
def rotation_from_cross_covariance(s_: torch.Tensor, iters: int = 16,
                                   fixed_order: bool = False) -> torch.Tensor:
    """Rotation maximising tr(R S) from [..., 3, 3] cross-covariances S
    (Horn's quaternion eigenvector).  `fixed_order` multiplies the 4x4
    matrices in an order that does not depend on the leading axes
    (`matmul_small`), as the frame-batched `procrustes` needs; without it
    they are torch matmuls (PnP's nearest rotation).  The norms are sums
    of 4 and 16 contiguous elements, whose order does not move either."""
    sxx, sxy, sxz = s_[..., 0, 0], s_[..., 0, 1], s_[..., 0, 2]
    syx, syy, syz = s_[..., 1, 0], s_[..., 1, 1], s_[..., 1, 2]
    szx, szy, szz = s_[..., 2, 0], s_[..., 2, 1], s_[..., 2, 2]
    n = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1),
    ], -2)
    # shift so the largest eigenvalue of N dominates in magnitude, then
    # square the matrix four times: one matvec then applies M^16
    matmul = matmul_small if fixed_order else torch.matmul
    shift = torch.sqrt((n * n).sum((-1, -2)))[..., None, None] + 1e-12
    m = n / shift + torch.eye(4, dtype=n.dtype, device=n.device)
    for _ in range(4):
        m = matmul(m, m)
        m = m / torch.sqrt((m * m).sum((-1, -2))).clamp(min=1e-20)[..., None, None]
    q = torch.full(n.shape[:-1], 0.5, dtype=n.dtype, device=n.device)
    for _ in range(iters):
        q = matmul(m, q[..., None])[..., 0]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-20)
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)


@f32_matmuls
def backproject(uv: torch.Tensor, depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """[..., N, 2] pixels + [..., N] depths -> [..., N, 3] camera-frame points."""
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], -1)


@f32_matmuls
def project(pts: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """[..., N, 3] camera-frame points -> [..., N, 2] pixels (no distortion)."""
    z = pts[..., 2]
    z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    return torch.stack([pts[..., 0] / z * fx + cx, pts[..., 1] / z * fy + cy], -1)

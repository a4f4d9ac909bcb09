"""SO(3)/SE(3) Lie group operations (twin of `cusift_tpu/optim/lie.py`).

Elementwise over leading batch dimensions and differentiable, forward mode
included (`torch.func.jacfwd`): the small-angle Taylor branches sit behind
`torch.where` and the norms are floored at 1e-24 before the square root,
so Jacobians at zero twist stay finite, as in the reference.  `inverse`
and `se3_log`, which the tracking chunk runs over its frame axis, multiply
their 3x3 matrices with `ops/mat3.py:matmul_small`, so frame b of a batch
equals the frame alone, bit for bit.
"""

from __future__ import annotations

import torch

from ..ops.mat3 import matmul_small
from ..utils.precision import f32_matmuls

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _safe_norm(w: torch.Tensor) -> torch.Tensor:
    """Differentiable-at-zero norm: [..., 3] -> [..., 1, 1]."""
    sq = (w * w).sum(-1, keepdim=True)
    return torch.sqrt(torch.clamp(sq, min=1e-24))[..., None]


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x with Taylor fallback."""
    small = x.abs() < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xs) / xs)


def _cosc(x: torch.Tensor) -> torch.Tensor:
    """(1 - cos(x)) / x^2 with Taylor fallback."""
    small = x.abs() < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x * x / 24.0, (1.0 - torch.cos(xs)) / (xs * xs))


@f32_matmuls
def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3] rotation (Rodrigues)."""
    th = _safe_norm(w)
    k = hat(w)
    return _eye3(w) + _sinc(th) * k + _cosc(th) * (k @ k)


@f32_matmuls
def so3_log(r: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle (theta < pi - eps).

    atan2(sin, cos) rather than arccos keeps derivatives finite at the
    identity.
    """
    # trailing axes are kept (not added after the products): under
    # vmap(jacfwd), a 0-d tensor times a float and then unsqueezed carries
    # a float64 tangent into the next matmul
    tr = (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2])[..., None]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                     r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], -1)
    sin_t = 0.5 * torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-24))
    th = torch.atan2(sin_t, cos_t)
    # v = 2 sin(theta) * axis;  w = theta * axis = v * theta / (2 sin theta)
    return 0.5 * v / torch.clamp(_sinc(th), min=_EPS)


@f32_matmuls
def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V: se3_exp's translation factor."""
    th = _safe_norm(w)
    k = hat(w)
    small = th < 1e-4
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 0.5 - th * th / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    b = torch.where(small, 1.0 / 6.0 - th * th / 120.0, (ths - torch.sin(ths)) / (ths ** 3))
    return _eye3(w) + a * k + b * (k @ k)


@f32_matmuls
def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    th = _safe_norm(w)
    k = hat(w)
    small = th < 1e-4
    ths = torch.where(small, torch.ones_like(th), th)
    cot = torch.where(
        small, 1.0 / 12.0 + th * th / 720.0,
        (1.0 - 0.5 * ths * torch.sin(ths)
         / torch.clamp(1.0 - torch.cos(ths), min=_EPS)) / (ths * ths))
    return _eye3(w) - 0.5 * k + cot * matmul_small(k, k)


@f32_matmuls
def se3_exp(xi: torch.Tensor):
    """[..., 6] twist (v, w) -> (R [..., 3, 3], t [..., 3])."""
    v, w = xi[..., :3], xi[..., 3:]
    return so3_exp(w), (_left_jacobian(w) @ v[..., None])[..., 0]


@f32_matmuls
def se3_log(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [..., 6] twist (v, w)."""
    w = so3_log(r)
    v = matmul_small(_left_jacobian_inv(w), t[..., None])[..., 0]
    return torch.cat([v, w], -1)


@f32_matmuls
def transform(r: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to points [..., 3]."""
    return (r @ p[..., None])[..., 0] + t


@f32_matmuls
def compose(ra, ta, rb, tb):
    """(Ra, ta) o (Rb, tb): apply b first, then a."""
    return ra @ rb, (ra @ tb[..., None])[..., 0] + ta


@f32_matmuls
def inverse(r, t):
    rt = r.transpose(-1, -2)
    return rt, -matmul_small(rt, t[..., None])[..., 0]


@f32_matmuls
def retract(r, t, xi):
    """Left-multiplicative retraction: exp(xi) o (R, t)."""
    dr, dt = se3_exp(xi)
    return compose(dr, dt, r, t)

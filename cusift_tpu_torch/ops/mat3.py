"""Closed-form small linear algebra (twin of `cusift_tpu/ops/mat3.py`).

Every routine is elementwise over leading batch dimensions, so a batch of
RANSAC hypotheses never goes through a general LU or Cholesky routine.
Degenerate inputs give finite garbage that the callers' scoring rejects,
never an exception.
"""

from __future__ import annotations

import torch

from ..utils.precision import f32_matmuls


def det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3]."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of [..., 3, 3]."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c10, c11, c12], -1),
        torch.stack([c20, c21, c22], -1),
    ], -2)


@f32_matmuls
def inv3(m: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Inverse of [..., 3, 3]; singular inputs return adj/eps-guarded det."""
    d = det3(m)[..., None, None]
    d = torch.where(d.abs() > eps, d,
                    torch.where(d >= 0, torch.full_like(d, eps),
                                torch.full_like(d, -eps)))
    return adjugate3(m) / d


@f32_matmuls
def solve3(m: torch.Tensor, b: torch.Tensor, eps: float = 1e-12):
    """Solve m x = b for [..., 3, 3] x [..., 3]; returns (x, ok)."""
    d = det3(m)
    ok = d.abs() > eps
    dd = torch.where(ok, d, torch.ones_like(d))
    x = (adjugate3(m) @ b[..., None])[..., 0] / dd[..., None]
    return torch.where(ok[..., None], x, torch.zeros_like(x)), ok


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD A [..., n, n] via unrolled Cholesky.

    Statically unrolled over n (intended n <= ~10), so every step is an
    elementwise op over the batch.  Callers regularise A (ridge);
    degenerate systems produce finite garbage that downstream scoring
    rejects.
    """
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, -1)


@f32_matmuls
def inv3_spd(a: torch.Tensor, rel_floor: float = 3e-7) -> torch.Tensor:
    """Inverse of PSD [..., 3, 3] via closed-form Cholesky (stable in f32).

    The cofactor inverse (inv3) is catastrophically wrong in f32 past
    condition ~1e7.  Cholesky is backward stable; pivot squares are
    clamped to rel_floor times the largest diagonal entry, so f32
    cancellation acts as bounded extra damping of a thin direction instead
    of a blow-up: ||inv|| <= 1/(rel_floor * max_diag).
    """
    d11, d22, d33 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    floor = rel_floor * torch.maximum(d11, torch.maximum(d22, d33)) + 1e-30
    l11 = torch.sqrt(torch.maximum(d11, floor))
    l21 = a[..., 1, 0] / l11
    l31 = a[..., 2, 0] / l11
    l22 = torch.sqrt(torch.maximum(d22 - l21 * l21, floor))
    l32 = (a[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.maximum(d33 - l31 * l31 - l32 * l32, floor))
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m33 = 1.0 / l33
    m21 = -l21 * m11 * m22
    m31 = (l21 * l32 - l22 * l31) * m11 * m22 * m33
    m32 = -l32 * m22 * m33
    i11 = m11 * m11 + m21 * m21 + m31 * m31
    i12 = m21 * m22 + m31 * m32
    i13 = m31 * m33
    i22 = m22 * m22 + m32 * m32
    i23 = m32 * m33
    i33 = m33 * m33
    return torch.stack([torch.stack([i11, i12, i13], -1),
                        torch.stack([i12, i22, i23], -1),
                        torch.stack([i13, i23, i33], -1)], -2)

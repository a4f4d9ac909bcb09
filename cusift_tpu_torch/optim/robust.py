"""Robust M-estimator kernels for the pose graph, IRLS form (twin of
`cusift_tpu/optim/robust.py`).

The kernel acts on the per-edge residual NORM; edges are reweighted by the
sqrt IRLS weight at each linearisation, and step acceptance evaluates the
true rho-cost, so the LM loop optimises one objective.  "huber" bounds an
outlier's influence, "cauchy" lets it decay, "tukey" drops it entirely
beyond the scale (and needs a sane initialisation).
"""

from __future__ import annotations

import torch


def sqrt_weight(nrm: torch.Tensor, delta: float, kernel: str) -> torch.Tensor:
    """sqrt IRLS weight per edge given residual norms (delta > 0)."""
    x = nrm / delta
    if kernel == "huber":
        w = torch.where(x > 1.0, 1.0 / torch.clamp(x, min=1e-12), torch.ones_like(x))
    elif kernel == "cauchy":
        w = 1.0 / (1.0 + x * x)
    elif kernel == "tukey":
        w = torch.where(x < 1.0, (1.0 - x * x) ** 2, torch.zeros_like(x))
    else:
        raise ValueError(f"unknown robust kernel {kernel!r}")
    return torch.sqrt(w)


def rho(nrm: torch.Tensor, delta: float, kernel: str) -> torch.Tensor:
    """Per-edge robust cost given residual norms (delta > 0)."""
    x = nrm / delta
    if kernel == "huber":
        return torch.where(x <= 1.0, 0.5 * nrm ** 2, delta * (nrm - 0.5 * delta))
    if kernel == "cauchy":
        return 0.5 * delta * delta * torch.log1p(x * x)
    if kernel == "tukey":
        c2 = delta * delta / 6.0
        return c2 * (1.0 - torch.clamp(1.0 - x * x, 0.0, 1.0) ** 3)
    raise ValueError(f"unknown robust kernel {kernel!r}")

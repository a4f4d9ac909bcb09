"""Orientation assignment from fixed-grid gradient histograms (twin of
`cusift_tpu/ops/orientation.py`).

Every keypoint samples a fixed G x G grid over its circular support,
soft-assigns angles to a 36-bin histogram, and keeps up to
`max_orientations` peaks as static orientation slots.  The sampling goes
through kernel K1 by default and K6 with `sampler="separable"`; with
`sampler="fused"` kernel K4 samples and bins in one pass.  A batch of
frames ([B, ...] planes and keypoints) goes through each kernel in one
launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SiftConfig
from ..kernels import sampler as k
from .keypoints import Keypoints
from .sampling import sample_grad_grid


def _grid_offsets(g: int) -> np.ndarray:
    """Unit-square sample offsets in [-1, 1], cell centres; static."""
    c = (np.arange(g, dtype=np.float32) + 0.5) / g * 2.0 - 1.0
    vy, vx = np.meshgrid(c, c, indexing="ij")
    return np.stack([vy.ravel(), vx.ravel()], axis=-1)  # [g*g, 2]


def _smooth_hist(h: torch.Tensor) -> torch.Tensor:
    """Circular [1,4,6,4,1]/16 smoothing along the last axis (cv2.SIFT)."""
    r = torch.roll(h, 1, -1) + torch.roll(h, -1, -1)
    r2 = torch.roll(h, 2, -1) + torch.roll(h, -2, -1)
    return (6.0 * h + 4.0 * r + r2) / 16.0


def orientation_histograms(gauss: torch.Tensor, kps: Keypoints,
                           cfg: SiftConfig,
                           level_base: int = 0) -> torch.Tensor:
    """[..., K, ori_bins] gradient-direction histograms (octave-local
    sampling).

    gauss: [..., L, H, W] blurred levels of this octave, kps fields
    [..., K] with the same leading (frame) axes; plane i is Gaussian level
    i + level_base.
    """
    g = cfg.ori_grid
    nb = cfg.ori_bins
    dev = gauss.device
    offs = torch.as_tensor(_grid_offsets(g), device=dev)          # [S, 2]
    sigma_oct = cfg.sigma0 * torch.pow(2.0, kps.so / cfg.scales_per_octave)
    radius = cfg.ori_radius_factor * sigma_oct                 # [..., K]
    c1d = torch.as_tensor((np.arange(g, dtype=np.float32) + 0.5) / g * 2.0 - 1.0,
                          device=dev)
    ys_rows = kps.yo[..., None] + radius[..., None] * c1d      # [..., K, g]
    xs_cols = kps.xo[..., None] + radius[..., None] * c1d
    lvl = (kps.level - level_base).clamp(0, gauss.shape[-3] - 1)

    # Gaussian weight over the circular support; r in units of sigma
    r2 = (offs[:, 0] ** 2 + offs[:, 1] ** 2) * (cfg.ori_radius_factor ** 2)
    wgt = torch.exp(-r2 / (2.0 * cfg.ori_sigma_factor ** 2))
    wgt = wgt * (r2 <= cfg.ori_radius_factor ** 2)             # circular mask
    wv = wgt * kps.valid[..., None]                            # [..., K, S]

    if cfg.sampler == "fused":
        hist = k.sample_ori_hist(gauss.contiguous(), lvl.to(torch.int32).contiguous(),
                                 *k._grid(ys_rows, xs_cols), wv.contiguous(), nb)
    else:
        dx, dy, inb = sample_grad_grid(gauss, lvl, ys_rows, xs_cols,
                                       method=cfg.sampler)
        # soft 2-bin assignment: weight toward bin b is max(0, 1 - circ_dist)
        hist = k.orientation_bins(dx, dy, inb, wv, nb)
    return _smooth_hist(hist)


def dominant_orientations(hist: torch.Tensor, cfg: SiftConfig):
    """Up to cfg.max_orientations angles per keypoint from the histogram
    [..., K, nb].

    Returns (theta [..., K, M], ok [..., K, M]): slot 0 is the global peak;
    later slots are the next-best local peaks >= peak_ratio * max, at least
    two bins away from earlier picks.  Parabolic sub-bin refinement
    throughout.
    """
    nb = cfg.ori_bins
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    is_peak = (hist > left) & (hist > right)
    hmax = hist.max(dim=-1).values

    def at(a, b):  # a[..., b] of each row
        return a.gather(-1, b[..., None])[..., 0]

    def refine(b):  # b: [..., K] int64
        hc, hl, hr = at(hist, b), at(left, b), at(right, b)    # hist[b], [b-1], [b+1]
        denom = hl - 2 * hc + hr
        big = denom.abs() > 1e-12
        delta = torch.where(big, 0.5 * (hl - hr) / torch.where(big, denom, 1.0),
                            torch.zeros_like(denom))
        delta = delta.clamp(-0.5, 0.5)
        return torch.remainder((b + delta) / nb * 2.0 * math.pi, 2.0 * math.pi)

    thetas, oks = [], []
    score = torch.where(is_peak, hist, torch.full_like(hist, -torch.inf))
    bins = torch.arange(nb, device=hist.device)
    for _ in range(cfg.max_orientations):
        b = torch.argmax(score, dim=-1)
        val = at(score, b)
        ok = torch.isfinite(val) & (val >= cfg.ori_peak_ratio * hmax) & (hmax > 0)
        thetas.append(refine(b))
        oks.append(ok)
        # suppress +-1 bins around the chosen peak (circular)
        d = (torch.remainder(bins - b[..., None] + nb // 2, nb) - nb // 2).abs()
        score = torch.where(d <= 1, torch.full_like(score, -torch.inf), score)
    return torch.stack(thetas, -1), torch.stack(oks, -1)

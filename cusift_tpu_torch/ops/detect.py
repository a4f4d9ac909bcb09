"""DoG extrema detection and subpixel refinement (twin of
`cusift_tpu/ops/detect.py`).

The 26-neighbour test is three separable 3-tap max/min passes over the
[S+2, H, W] DoG stack; candidates are compacted with an exact top-k into
the octave's static budget (the reference's `approx_max_k` is exact off
the TPU too); refinement runs on the compacted candidates only, one
batched 3x3x3 gather plus closed-form 3x3 solves per iteration.  Every
stage takes leading frame axes: a batch's candidates are sorted frame by
frame in one sort, and its cubes gathered from each frame's own planes.
"""

from __future__ import annotations

import torch

from ..config import SiftConfig
from .keypoints import Keypoints, concat_keypoints, top_indices, topk_keypoints
from .mat3 import solve3
from .pyramid import Octave


def _extrema_mask(dog: torch.Tensor, prefilter: float) -> torch.Tensor:
    """[..., S, H, W] bool: 26-neighbour extrema of dog[..., 1:S+1, :, :]."""
    def _win(x, op):
        x = op(op(x[..., :-2, :, :], x[..., 1:-1, :, :]), x[..., 2:, :, :])  # scale
        x = op(op(x[..., :-2, :], x[..., 1:-1, :]), x[..., 2:, :])          # rows
        return op(op(x[..., :-2], x[..., 1:-1]), x[..., 2:])                 # cols

    wmax = _win(dog, torch.maximum)
    wmin = _win(dog, torch.minimum)
    centre = dog[..., 1:-1, 1:-1, 1:-1]
    # centre equals the window max/min iff it is >= / <= all 26
    # neighbours; plateau ties must also clear the prefilter
    is_max = (centre >= wmax) & (centre > prefilter)
    is_min = (centre <= wmin) & (centre < -prefilter)
    s, h, w = dog.shape[-3:]
    mask = torch.zeros(dog.shape[:-3] + (s - 2, h, w), dtype=torch.bool,
                       device=dog.device)
    mask[..., 1:-1, 1:-1] = is_max | is_min
    return mask


def extrema_score(dog: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """[..., S, H, W] candidate score of a [..., S+2, H, W] DoG stack:
    |DoG| at prefiltered extrema, else -inf.

    Keeps the DoG's dtype (f32, or bf16 for `score_dtype="bf16"`).
    """
    prefilter = 0.5 * cfg.contrast_thresh / cfg.scales_per_octave
    mask = _extrema_mask(dog, prefilter)
    mid = dog[..., 1:-1, :, :].abs()
    return torch.where(mask, mid, torch.full_like(mid, -torch.inf))


def _gather_cubes(dog: torch.Tensor, lvl, y, x) -> torch.Tensor:
    """[..., K, 3, 3, 3] DoG neighbourhoods around (lvl, y, x) [..., K],
    each from its own frame of dog [..., S, H, W].

    Each (1, 1, 3) row's start index is clamped into the stack like the
    reference's `GatherScatterMode.CLIP`; callers pre-clip to the interior
    so no clamp fires on the main path.
    """
    s, h, w = dog.shape[-3:]
    lead = dog.shape[:-3]
    d = torch.arange(-1, 2, device=dog.device)
    ll = (lvl[..., None] + d).clamp(0, s - 1)                  # [..., K, 3]
    yy = (y[..., None] + d).clamp(0, h - 1)
    x0 = (x - 1).clamp(0, w - 3)[..., None] + d + 1            # [..., K, 3]
    flat = (ll[..., :, None, None] * h + yy[..., None, :, None]) * w \
        + x0[..., None, None, :]                               # [..., K, 3, 3, 3]
    cubes = dog.reshape(lead + (-1,)).gather(-1, flat.reshape(lead + (-1,)).long())
    return cubes.reshape(flat.shape)


def _solve_at(dog, lvl, y, x):
    """Quadratic fit at integer locations: (v, g [..., K, 3], H [..., K, 3, 3],
    off, ok)."""
    c = _gather_cubes(dog, lvl, y, x)
    v = c[..., 1, 1, 1]
    dx = 0.5 * (c[..., 1, 1, 2] - c[..., 1, 1, 0])
    dy = 0.5 * (c[..., 1, 2, 1] - c[..., 1, 0, 1])
    ds = 0.5 * (c[..., 2, 1, 1] - c[..., 0, 1, 1])
    dxx = c[..., 1, 1, 2] - 2 * v + c[..., 1, 1, 0]
    dyy = c[..., 1, 2, 1] - 2 * v + c[..., 1, 0, 1]
    dss = c[..., 2, 1, 1] - 2 * v + c[..., 0, 1, 1]
    dxy = 0.25 * (c[..., 1, 2, 2] - c[..., 1, 2, 0] - c[..., 1, 0, 2] + c[..., 1, 0, 0])
    dxs = 0.25 * (c[..., 2, 1, 2] - c[..., 2, 1, 0] - c[..., 0, 1, 2] + c[..., 0, 1, 0])
    dys = 0.25 * (c[..., 2, 2, 1] - c[..., 2, 0, 1] - c[..., 0, 2, 1] + c[..., 0, 0, 1])
    g = torch.stack([dx, dy, ds], -1)
    hess = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                        torch.stack([dxy, dyy, dys], -1),
                        torch.stack([dxs, dys, dss], -1)], -2)  # [..., K, 3, 3]
    off, ok = solve3(hess, -g)
    return v, g, hess, off, ok


def _refine_batch(dog: torch.Tensor, lvl, y, x, cfg: SiftConfig):
    """Iteratively refine all candidates at once; arrays are [..., K]-shaped
    with dog's leading (frame) axes."""
    s_levels, h, w = dog.shape[-3:]
    ok = torch.ones_like(lvl, dtype=torch.bool)
    for _ in range(cfg.refine_iters):
        _, _, _, off, ok = _solve_at(dog, lvl, y, x)
        # move the integer location while the offset escapes the pixel
        moves = torch.round(off).to(torch.int32)
        x = (x + moves[..., 0]).clamp(1, w - 2)
        y = (y + moves[..., 1]).clamp(1, h - 2)
        lvl = (lvl + moves[..., 2]).clamp(1, s_levels - 2)
    # recompute at the final integer location for consistent derivatives
    v, g, hess, off, ok2 = _solve_at(dog, lvl, y, x)
    contrast = v + 0.5 * (g * off).sum(-1)

    converged = (off.abs() < 1.0).all(-1) & ok & ok2
    # 2x2 spatial-Hessian edge rejection
    tr = hess[..., 0, 0] + hess[..., 1, 1]
    det2 = hess[..., 0, 0] * hess[..., 1, 1] - hess[..., 0, 1] * hess[..., 0, 1]
    r = cfg.edge_thresh
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
    edgeness = torch.where(det2 > 0, tr * tr / det2.clamp(min=1e-12),
                           torch.full_like(det2, torch.inf))

    contrast_ok = contrast.abs() * cfg.scales_per_octave >= cfg.contrast_thresh
    xo = x.to(torch.float32) + off[..., 0]
    yo = y.to(torch.float32) + off[..., 1]
    so = lvl.to(torch.float32) + off[..., 2]
    in_bounds = ((xo >= cfg.border) & (xo < w - cfg.border) &
                 (yo >= cfg.border) & (yo < h - cfg.border))
    valid = converged & edge_ok & contrast_ok & in_bounds
    return xo, yo, so, lvl, contrast, edgeness, valid


def detect_octave(oct_: Octave, octave_idx: int, cfg: SiftConfig) -> Keypoints:
    """All keypoints of one octave, compacted to cfg.kpt_budget(octave)."""
    return detect_from_score(oct_.dog, extrema_score(oct_.dog, cfg), octave_idx, cfg)


def detect_from_score(dog: torch.Tensor, score: torch.Tensor,
                      octave_idx: int, cfg: SiftConfig) -> Keypoints:
    """Compaction + refinement of one octave from its extrema score.

    dog [..., S+2, H, W] and score [..., S, H, W] may carry leading frame
    axes; each frame's candidates are sorted and refined in its own planes,
    and the Keypoints fields are [..., k]."""
    h, w = dog.shape[-2:]
    k = cfg.kpt_budget(octave_idx)
    flat = score.reshape(score.shape[:-3] + (-1,))
    flat_idx = top_indices(flat, k)
    flat_score = flat.gather(-1, flat_idx)
    lvl = (flat_idx // (h * w)).to(torch.int32) + 1            # DoG level 1..S
    rem = flat_idx % (h * w)
    y = (rem // w).to(torch.int32).clamp(1, h - 2)             # in-bounds
    x = (rem % w).to(torch.int32).clamp(1, w - 2)              # gathers
    cand_valid = torch.isfinite(flat_score)

    xo, yo, so, lvl_f, contrast, edgeness, valid = _refine_batch(
        dog, lvl, y, x, cfg)
    valid = valid & cand_valid

    # octave-local -> base-image coordinates
    scale_mult = float(2 ** octave_idx) * (0.5 if cfg.upscale else 1.0)
    sigma = cfg.sigma0 * torch.pow(2.0, so / cfg.scales_per_octave) * scale_mult
    return Keypoints(
        x=xo * scale_mult, y=yo * scale_mult, sigma=sigma,
        response=contrast, edgeness=edgeness,
        octave=torch.full_like(lvl_f, octave_idx),
        level=lvl_f, xo=xo, yo=yo, so=so, valid=valid,
    )


def detect(octaves: list[Octave], cfg: SiftConfig) -> Keypoints:
    """Keypoints over all octaves, compacted to the global cfg.max_kpts."""
    per_oct = [detect_octave(o, i, cfg) for i, o in enumerate(octaves)]
    return topk_keypoints(concat_keypoints(per_oct), cfg.max_kpts)

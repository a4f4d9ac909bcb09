"""Rectified-stereo feature depth (twin of `cusift_tpu/ops/stereo.py`).

A rectified pair turns one descriptor match per left feature into metric
depth, z = fx * b / disparity.  The left-right match is the ratio-test
match of `ops/match.py` (kernel K2 on the card) over the whole right
feature set; the epipolar constraints of a rectified pair (same row,
positive disparity) are masks applied after it.
"""

from __future__ import annotations

import torch

from ..config import MatchConfig
from .match import match


def stereo_depth(desc_l, valid_l, x_l, y_l, desc_r, valid_r, x_r, y_r,
                 fx, baseline, match_cfg: MatchConfig = MatchConfig(),
                 row_tol: float = 1.5, min_disp: float = 0.75,
                 min_depth: float = 0.2):
    """Per-left-slot metric depth from one rectified stereo pair.

    Returns (depth [N], ok [N]), depth 0 where no admissible right match
    exists.  Gates: the ratio-test match, |row difference| <= row_tol px,
    disparity above min_disp px (distant points carry no stereo
    information) and below fx*b/min_depth (a gross mismatch would give an
    absurdly near point).  With a leading frame axis on both sides ([B, N]
    lefts, [B, M] rights) the B pairs take one batched match, and pair b
    equals the pair alone, bit for bit.
    """
    m = match(desc_l, valid_l, desc_r, valid_r, match_cfg)
    idx = m.idx.long()
    xr, yr = torch.gather(x_r, -1, idx), torch.gather(y_r, -1, idx)
    disp = x_l - xr
    fb = fx * baseline
    ok = (m.ok & valid_l & ((y_l - yr).abs() <= row_tol)
          & (disp > min_disp) & (disp < fb / min_depth))
    depth = torch.where(ok, fb / disp.clamp(min=1e-6), torch.zeros_like(disp))
    return depth, ok

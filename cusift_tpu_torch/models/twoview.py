"""Two-view pipeline: extract + match + RANSAC homography (twin of the
homography part of `cusift_tpu/models/twoview.py`).

This is the port's main path: both extractions run the gradient sampler
(K1) on every octave by default, and the matcher runs the fused top-2 (K2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchConfig, RansacConfig, SiftConfig
from ..ops.match import Matches, match
from ..ops.ransac import HomographyResult, find_homography
from ..utils.device import as_input
from .sift import SiftFeatures, extract


class TwoViewResult(NamedTuple):
    feats_a: SiftFeatures
    feats_b: SiftFeatures
    matches: Matches
    homography: HomographyResult


def _correspondences(fa: SiftFeatures, fb: SiftFeatures, m: Matches):
    """Matched point pairs [N, 2] in image coords + validity."""
    j = m.idx.long()
    pa = torch.stack([fa.x, fa.y], -1)
    pb = torch.stack([fb.x[j], fb.y[j]], -1)
    return pa, pb, m.ok


def mask_to_content(f: SiftFeatures, content, border: int) -> SiftFeatures:
    """Invalidate features outside a (h, w) content region (tier-padded
    inputs produce spurious responses along the content/pad boundary)."""
    if content is None:
        return f
    content = torch.as_tensor(content, device=f.x.device)
    h = content[0].to(torch.float32)
    w = content[1].to(torch.float32)
    b = float(border)
    valid = (f.valid & (f.x >= b) & (f.x < w - b)
             & (f.y >= b) & (f.y < h - b))
    return f._replace(valid=valid)


def match_pair(img_a, img_b,
               sift_cfg: SiftConfig = SiftConfig(),
               match_cfg: MatchConfig = MatchConfig(),
               ransac_cfg: RansacConfig = RansacConfig(),
               generator: torch.Generator | None = None,
               content_a=None, content_b=None, *, device=None) -> TwoViewResult:
    """Full grayscale pair pipeline -> features, matches, homography.

    The images are tensors, which stay on their device, or numpy arrays,
    which go to `device` (default "cuda"; see `utils/device.py`).
    content_a/content_b: optional (h, w) of the true image content when
    the inputs are tier-padded (see `mask_to_content`).
    """
    img_a, img_b = as_input(img_a, device), as_input(img_b, device)
    fa = mask_to_content(extract(img_a, sift_cfg), content_a, sift_cfg.border)
    fb = mask_to_content(extract(img_b, sift_cfg), content_b, sift_cfg.border)
    m = match(fa.desc, fa.valid, fb.desc, fb.valid, match_cfg)
    pa, pb, ok = _correspondences(fa, fb, m)
    h = find_homography(pa, pb, ok, ransac_cfg, generator)
    return TwoViewResult(feats_a=fa, feats_b=fb, matches=m, homography=h)

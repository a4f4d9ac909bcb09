"""Two-view pipelines: extract + match + RANSAC homography or RGB-D rigid
alignment (twin of `cusift_tpu/models/twoview.py`).

Both extractions run the gradient sampler (K1) on every octave by default,
and the matcher runs the fused top-2 (K2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchConfig, RansacConfig, SiftConfig
from ..ops.match import Matches, match
from ..ops.geometry import backproject
from ..ops.ransac import HomographyResult, RigidResult, find_homography, find_rigid
from ..utils import trace
from ..utils.device import as_input
from ..utils.precision import f32_matmuls
from .sift import SiftFeatures, extract


class TwoViewResult(NamedTuple):
    feats_a: SiftFeatures
    feats_b: SiftFeatures
    matches: Matches
    homography: HomographyResult


class RigidPairResult(NamedTuple):
    feats_a: SiftFeatures
    feats_b: SiftFeatures
    matches: Matches
    rigid: RigidResult


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


@trace.traced("twoview.match_pair")
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


def depth_at(depth: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Depth at the nearest pixel of (xs, ys), rounding half to even as the
    reference's `jnp.round` does (`torch.round` does the same).  depth
    [..., H, W] with xs, ys [..., N] over the same leading (frame) axes."""
    h, w = depth.shape[-2:]
    xi = torch.round(xs).long().clamp(0, w - 1)
    yi = torch.round(ys).long().clamp(0, h - 1)
    return torch.gather(depth.flatten(-2), -1, yi * w + xi)


@f32_matmuls
def align_rgbd_pair(img_a, depth_a, img_b, depth_b, intrinsics,
                    sift_cfg: SiftConfig = SiftConfig(),
                    match_cfg: MatchConfig = MatchConfig(),
                    ransac_cfg: RansacConfig = RansacConfig(),
                    generator: torch.Generator | None = None, *,
                    device=None) -> RigidPairResult:
    """RGB-D pair -> rigid transform taking camera-A points to camera-B.

    intrinsics: [4] = (fx, fy, cx, cy).  Matches with invalid depth
    (<= 1e-6) at either end are masked out before RANSAC.  Numpy images
    go to `device` (default "cuda"; see `utils/device.py`); the intrinsics
    follow img_a.
    """
    img_a, depth_a = as_input(img_a, device), as_input(depth_a, device)
    img_b, depth_b = as_input(img_b, device), as_input(depth_b, device)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=img_a.device)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    fa = extract(img_a, sift_cfg)
    fb = extract(img_b, sift_cfg)
    m = match(fa.desc, fa.valid, fb.desc, fb.valid, match_cfg)
    j = m.idx.long()
    xb, yb = fb.x[j], fb.y[j]
    da = depth_at(depth_a, fa.x, fa.y)
    db = depth_at(depth_b, xb, yb)
    pa3 = backproject(torch.stack([fa.x, fa.y], -1), da, fx, fy, cx, cy)
    pb3 = backproject(torch.stack([xb, yb], -1), db, fx, fy, cx, cy)
    ok = m.ok & (da > 1e-6) & (db > 1e-6)
    rig = find_rigid(pa3, pb3, ok, ransac_cfg, generator)
    return RigidPairResult(feats_a=fa, feats_b=fb, matches=m, rigid=rig)

"""Stereo keyframe SLAM (twin of `cusift_tpu/models/stereo.py`; BASELINE
configs[4], KITTI-style rectified rigs).

A rectified pair supplies metric depth per feature (`ops/stereo.py`), so
the whole RGB-D backend of `models/slam.py` (keyframe ring, window BA,
loop closure, pose graph, eviction, checkpoint/resume) runs unchanged on
stereo pairs at metric scale.  A tracking step extracts both images in
one `extract_batch` (kernel K1 in every octave of each), matches left to
right for depth (K2) and left to the keyframe for tracking (K2, then
rigid RANSAC), and packs the same [22] row as `_frame_step`, so
`Slam._commit` applies it as it stands.  A chunk of N pairs
(`_stereo_chunk_step`, the reference's `jax.vmap(_stereo_frame_step)`)
takes one `extract_batch` of its 2N images, one batched left-right match
and one batched tracking match + RANSAC: two K2 launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MatchConfig, RansacConfig, SiftConfig
from ..ops.geometry import backproject
from ..ops.stereo import stereo_depth
from ..utils.device import as_input
from ..utils.precision import f32_matmuls
from .sift import SiftFeatures, extract_batch
from .slam import Slam, _frame_of, _tracking_row, _tracking_rows


def _stereo_points(fl: SiftFeatures, fr: SiftFeatures, intr, baseline,
                   match_cfg: MatchConfig):
    """Metric 3D points of the left features (z = 0 where no admissible
    right match) and their validity; over the frame axis of a batch of
    pairs (one batched `stereo_depth`)."""
    depth, dok = stereo_depth(fl.desc, fl.valid, fl.x, fl.y, fr.desc, fr.valid,
                              fr.x, fr.y, intr[0], baseline, match_cfg)
    pts = backproject(torch.stack([fl.x, fl.y], -1), depth,
                      intr[0], intr[1], intr[2], intr[3])
    return pts, dok


@f32_matmuls
def _extract_stereo_points(img_l, img_r, intr, baseline,
                           sift_cfg: SiftConfig, match_cfg: MatchConfig):
    """Left features + metric 3D backprojections from one rectified pair,
    both images in one `extract_batch` of 2."""
    f2 = extract_batch(torch.stack([img_l, img_r]), sift_cfg)
    fl = _frame_of(f2, 0)
    return (fl, *_stereo_points(fl, _frame_of(f2, 1), intr, baseline, match_cfg))


@f32_matmuls
def _stereo_frame_step(img_l, img_r, intr, baseline, ref_desc, ref_valid, ref_pts,
                       sift_cfg: SiftConfig, match_cfg: MatchConfig,
                       ransac_cfg: RansacConfig, generator):
    """One stereo tracking step, packed as `slam._frame_step` packs it."""
    f, pts, pvalid = _extract_stereo_points(img_l, img_r, intr, baseline,
                                            sift_cfg, match_cfg)
    return f, pts, _tracking_row(f, pts, pvalid, ref_desc, ref_valid, ref_pts,
                                 match_cfg, ransac_cfg, generator)


@f32_matmuls
def _stereo_chunk_step(frames, intr, baseline, ref_desc, ref_valid, ref_pts,
                       sift_cfg: SiftConfig, match_cfg: MatchConfig,
                       ransac_cfg: RansacConfig, generators):
    """Track a [N, 2, H, W] chunk of (left, right) pairs against ONE
    reference keyframe, as the reference's `jax.vmap(_stereo_frame_step)`:
    one `extract_batch` over the 2N images, one batched stereo depth over
    the N pairs, then one batched match and rigid RANSAC (frame i draws
    from generators[i]).  Returns the left features [N, ...], points
    [N, K, 3] and rows [N, 22]; row i equals `_stereo_frame_step` of pair i.
    """
    n = frames.shape[0]
    f2 = extract_batch(frames.reshape((2 * n,) + frames.shape[2:]), sift_cfg)
    left = SiftFeatures(*(a[0::2] for a in f2))
    right = SiftFeatures(*(a[1::2] for a in f2))
    pts, pvalid = _stereo_points(left, right, intr, baseline, match_cfg)
    rows = _tracking_rows(left, pts, pvalid, ref_desc, ref_valid, ref_pts,
                          match_cfg, ransac_cfg, generators)
    return left, pts, rows


class StereoSlam(Slam):
    """Sequential stereo SLAM: `Slam` with stereo-derived depth.

    `run` and `process_frame` take (img_left, img_right) pairs in place of
    (img, depth); everything after perception is `Slam`'s, at metric
    scale.  `baseline` is the rectified rig's baseline in metres (> 0);
    the other keywords are `Slam`'s, `device=` included.
    """

    def __init__(self, intr, baseline: float, **kw):
        if not baseline > 0:
            raise ValueError(f"StereoSlam: the rig's baseline must be > 0 m, got {baseline}")
        super().__init__(intr, **kw)
        self.baseline = torch.tensor(np.float32(baseline), device=self.device)

    def _sense(self, img, aux):
        f, pts, _ = _extract_stereo_points(
            as_input(img, self.device), as_input(aux, self.device), self.intr,
            self.baseline, self.sift_cfg, self.match_cfg)
        return f, pts

    def _sense_step(self, img, aux, kd, kv, kp, key):
        return _stereo_frame_step(
            as_input(img, self.device), as_input(aux, self.device), self.intr,
            self.baseline, kd, kv, kp, self.sift_cfg, self.match_cfg,
            self.ransac_cfg, key)

    def _chunk_sense_step(self, fchunk, kd, kv, kp, keys):
        return _stereo_chunk_step(fchunk, self.intr, self.baseline, kd, kv, kp,
                                  self.sift_cfg, self.match_cfg, self.ransac_cfg, keys)

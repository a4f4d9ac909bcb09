"""Deferred keyframe events and window BA in the port's SLAM loop
(cusift_tpu_torch/models/slam.py), at the bounds of tests/test_slam.py::
test_deferred_events_match_eager (bit-identical trajectories and metric
records through `run`) and tests/test_local_ba.py::
test_slam_with_local_ba_not_worse (ATE with window BA within 1.1x of
without, under 1% depth noise)."""

import numpy as np
import torch

from cusift_tpu_torch.config import PoseGraphConfig, RansacConfig, SiftConfig, SlamConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
from cusift_tpu_torch.models.slam import Slam

torch.set_num_threads(2)

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)


def test_deferred_events_match_eager():
    seq = planar_rgbd_sequence(24, 240, 320, motion_scale=0.9, seed=5)
    cfg = dict(max_keyframes=32, kf_min_inliers=220, kf_max_translation=0.06,
               kf_max_rotation=0.06, loop_temporal_gap=4, loop_min_score=0.05,
               loop_min_inliers=25)

    def run(defer):
        slam = Slam(seq.intr, sift_cfg=SIFT, ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                    slam_cfg=SlamConfig(defer_events=defer, **cfg),
                    pg_cfg=PoseGraphConfig(solver="dense"), device="cpu")
        slam.run(zip(seq.images, seq.depths), chunk=1)
        return slam

    sd, se = run(True), run(False)
    assert sd.state.n_kf == se.state.n_kf
    assert sd.state.n_closures == se.state.n_closures >= 1
    assert sd.state.edge_i == se.state.edge_i
    assert [r["loop"] for r in sd.metrics] == [r["loop"] for r in se.metrics]
    rd, td = sd.trajectory()
    re_, te = se.trajectory()
    np.testing.assert_array_equal(td, te)
    np.testing.assert_array_equal(rd, re_)


def test_slam_with_local_ba_not_worse():
    seq = planar_rgbd_sequence(10, 240, 320, seed=7, motion_scale=1.2)
    rs = np.random.default_rng(1)
    noisy_depth = seq.depths * (1.0 + rs.normal(scale=0.01, size=seq.depths.shape)
                                ).astype(np.float32)

    def run(local_w):
        slam_cfg = SlamConfig(max_keyframes=16, kf_min_inliers=120,
                              kf_max_translation=0.08, kf_max_rotation=0.08,
                              local_ba_window=local_w)
        s = Slam(seq.intr, sift_cfg=SiftConfig(max_kpts=384, max_kpts_per_octave=256,
                                               num_octaves=3),
                 slam_cfg=slam_cfg, ransac_cfg=RansacConfig(num_hypotheses=256), device="cpu")
        s.run(zip(seq.images, noisy_depth))
        return s.ate(seq.poses_r, seq.poses_t), s

    ate_off, _ = run(0)
    ate_on, slam_on = run(4)
    assert slam_on.state.n_kf >= 4
    assert ate_on <= ate_off * 1.1 + 1e-4

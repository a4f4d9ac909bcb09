"""The port's loop closure and fused keyframe event
(cusift_tpu_torch/models/slam.py) at the bounds of tests/test_slam.py:
`test_loop_closure_fires_and_holds_accuracy` and
`test_fused_events_match_split_path` (same keyframes, same closures, same
edges, trajectories within 1e-3).  The fused run pins nothing: its
events always take the dense graph solver, which is what the split run is
given, so one fused run serves both tests.
"""

import numpy as np
import pytest
import torch

from cusift_tpu_torch.config import PoseGraphConfig, RansacConfig, SiftConfig, SlamConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
from cusift_tpu_torch.models.slam import Slam

torch.set_num_threads(2)

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
CFG = dict(max_keyframes=32, kf_min_inliers=220, kf_max_translation=0.06,
           kf_max_rotation=0.06, loop_temporal_gap=4, loop_min_score=0.05,
           loop_min_inliers=25)


@pytest.fixture(scope="module")
def seq():
    return planar_rgbd_sequence(24, 240, 320, motion_scale=0.9, seed=5)


def _run(seq, fused):
    slam = Slam(seq.intr, sift_cfg=SIFT, ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                slam_cfg=SlamConfig(fused_events=fused, **CFG),
                pg_cfg=PoseGraphConfig(solver="dense"), device="cpu")
    for i in range(24):
        slam.process_frame(seq.images[i], seq.depths[i])
    return slam


@pytest.fixture(scope="module")
def fused(seq):
    return _run(seq, True)


def test_loop_closure_fires_and_holds_accuracy(seq, fused):
    assert fused.state.n_closures >= 1
    assert fused.state.n_kf >= 10        # keyframes keep inserting post-closure
    assert fused.ate(seq.poses_r, seq.poses_t) < 0.05
    assert any(w == 2.0 for w in fused.state.weight)
    assert sum(r["loop"] for r in fused.metrics) == fused.state.n_closures


def test_fused_events_match_split_path(seq, fused):
    split = _run(seq, False)
    assert fused.state.n_kf == split.state.n_kf
    assert fused.state.n_closures == split.state.n_closures >= 1
    assert fused.state.edge_i == split.state.edge_i
    rf, tf = fused.trajectory()
    rs, ts = split.trajectory()
    np.testing.assert_allclose(tf, ts, atol=1e-3)
    np.testing.assert_allclose(rf, rs, atol=1e-3)

"""Disk -> loader -> SLAM -> ATE on both dataset formats for the port
(the twin of tests/test_e2e_disk.py's two tests, which are slow-tier for
the JAX package and take seconds here).

A short synthetic sequence is written in the TUM and KITTI layouts by the
port's own writer (`data/disk.py`: 8-bit PNG images, 16-bit depth at scale
5000, calib and pose files), then `load_tum -> Slam` and
`load_stereo -> StereoSlam` run on the CPU and are held to the
reference's bars: every frame tracked and ATE < 0.05 m against the
ground truth read back from disk (metric for stereo, with the baseline
decoded from calib.txt's P1).
"""

import numpy as np
import pytest
import torch

from cusift_tpu_torch import SiftConfig, SlamConfig
from cusift_tpu_torch.data import kitti, tum
from cusift_tpu_torch.data.disk import write_kitti, write_tum
from cusift_tpu_torch.data.evaluation import ate_rmse
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, two_plane_stereo_sequence
from cusift_tpu_torch.models.slam import Slam
from cusift_tpu_torch.models.stereo import StereoSlam

torch.set_num_threads(2)

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)


@pytest.fixture(scope="module")
def tum_e2e_dir(tmp_path_factory):
    seq = planar_rgbd_sequence(n_frames=8, h=240, w=320, seed=2, motion_scale=0.6)
    return write_tum(str(tmp_path_factory.mktemp("e2e")), seq.images, seq.depths,
                     seq.poses_r, seq.poses_t, seq.timestamps, name="rgbd_dataset_freiburg1_e2e")


def test_tum_disk_to_trajectory(tum_e2e_dir):
    d = tum_e2e_dir
    assert tum.available(d)
    intr = tum.intrinsics_for(d)
    frames = list(tum.load_tum(d))
    assert len(frames) == 8
    slam = Slam(intr, sift_cfg=SIFT, slam_cfg=SlamConfig(max_keyframes=8, loop_temporal_gap=50),
                device="cpu")
    recs = slam.run((f.image, f.depth) for f in frames)
    assert sum(r.get("tracked", True) for r in recs) == 8
    rows = tum.load_groundtruth(d)
    assert len(rows) == 8
    ate = slam.ate(np.stack([r for _, r, _ in rows]), np.stack([t for _, _, t in rows]))
    assert ate < 0.05, f"disk-chain ATE {ate:.4f} m"


@pytest.fixture(scope="module")
def kitti_e2e_dir(tmp_path_factory):
    seq = two_plane_stereo_sequence(n_frames=8, h=240, w=320, seed=4, motion_scale=0.7,
                                    amplitude=2.0, baseline=0.12)
    return write_kitti(str(tmp_path_factory.mktemp("e2e_kitti")), seq.images_l, seq.intr,
                       seq.poses_r, seq.poses_t, images_r=seq.images_r, baseline=seq.baseline)


def test_kitti_disk_to_trajectory(kitti_e2e_dir):
    seq_dir, pose_file = kitti_e2e_dir
    assert kitti.stereo_available(seq_dir)
    intr = kitti.load_calib(seq_dir)
    baseline = kitti.load_baseline(seq_dir)
    assert abs(baseline - 0.12) < 1e-6
    slam = StereoSlam(intr, baseline, sift_cfg=SIFT,
                      slam_cfg=SlamConfig(max_keyframes=16, loop_temporal_gap=50), device="cpu")
    recs = slam.run(kitti.load_stereo(seq_dir))
    assert len(recs) == 8 and sum(r.get("tracked", True) for r in recs) == 8
    gt = kitti.load_poses(pose_file)
    ate = ate_rmse(*slam.trajectory(), np.stack([r for r, _ in gt]), np.stack([t for _, t in gt]))
    assert ate < 0.05, f"metric disk-chain ATE {ate:.4f} m"

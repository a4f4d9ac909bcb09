"""The port's small SfM (cusift_tpu_torch/models/sfm.py) at the bars of
tests/test_sfm.py.

* `reconstruct_rgbd` on test_sfm.py's fixture (6 frames at 240x320, 384
  keypoints): more than 40 tracks spanning >= 2 frames on average, BA cost
  decreasing, finite landmarks, ATE < 0.02 m, landmarks on the z = 2 plane.
* `reconstruct_mono` on test_sfm.py's 10-frame two-plane scene meets
  the trajectory bar (Sim(3)-aligned ATE < 5% of the path); the
  structure (landmarks in front of the init camera, the far/near depth
  ratio) is not asserted: it fails in the reference too (ROADMAP queue
  3).  Its track graph against the JAX package's is
  tests/test_torch_sfm_jax.py.
"""

import numpy as np
import pytest
import torch

import cusift_tpu_torch.models.sfm as tsfm
from cusift_tpu_torch.config import BAConfig, RansacConfig, SiftConfig
from cusift_tpu_torch.data.evaluation import ate_rmse, trajectory_path_length
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, two_plane_sequence

torch.set_num_threads(2)

SIFT = dict(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)


@pytest.fixture(scope="module")
def recon():
    seq = planar_rgbd_sequence(n_frames=6, h=240, w=320, seed=4, motion_scale=0.5)
    rec = tsfm.reconstruct_rgbd(
        seq.images, seq.depths, seq.intr, sift_cfg=SiftConfig(**SIFT),
        ransac_cfg=RansacConfig(num_hypotheses=512, inlier_thresh_3d=0.03),
        ba_cfg=BAConfig(max_iters=12, cg_iters=30, huber_delta=4.0, num_fixed_poses=2),
        max_tracks=1024, device="cpu")
    return seq, rec


def test_tracks_and_observations(recon):
    _, rec = recon
    assert rec.n_tracks > 40
    assert rec.n_obs / rec.n_tracks >= 2.0


def test_ba_converged(recon):
    _, rec = recon
    assert float(rec.ba.cost) < float(rec.ba.initial_cost)
    assert np.isfinite(rec.points).all()


def test_trajectory_accuracy(recon):
    seq, rec = recon
    ate = ate_rmse(rec.poses_r, rec.poses_t, seq.poses_r, seq.poses_t)
    assert ate < 0.02, f"SfM ATE {ate:.4f} m"


def test_landmarks_on_plane(recon):
    _, rec = recon
    assert np.median(np.abs(rec.points[:, 2] - 2.0)) < 0.05


def test_entry_points_need_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsfm.reconstruct_mono([np.zeros((32, 32), np.float32)] * 3, np.ones(4, np.float32))


@pytest.fixture(scope="module")
def mono_seq():
    return two_plane_sequence(10, 240, 320, seed=3, motion_scale=0.8)


def test_reconstruct_mono_trajectory(mono_seq):
    seq = mono_seq
    rec = tsfm.reconstruct_mono(seq.images, seq.intr, sift_cfg=SiftConfig(**SIFT),
                                ransac_cfg=RansacConfig(num_hypotheses=512), device="cpu")
    assert np.isfinite(rec.poses_t).all() and np.isfinite(rec.points).all()
    ate = ate_rmse(rec.poses_r, rec.poses_t, seq.poses_r, seq.poses_t, with_scale=True)
    path = trajectory_path_length(seq.poses_r, seq.poses_t)[-1]
    assert ate < 0.05 * path, (ate, path)

"""State carried across: the port's `Slam.restore` reads a checkpoint that
the JAX package's `Slam.checkpoint` wrote after 4 frames (same .npz keys),
reconstructs the same trajectory to 1e-6 and goes on tracking frame 4; and
the JAX package restores the port's checkpoint to the same trajectory."""

import numpy as np
import pytest
import torch

from cusift_tpu.config import RansacConfig as JRansacConfig
from cusift_tpu.config import SiftConfig as JSiftConfig
from cusift_tpu.config import SlamConfig as JSlamConfig
from cusift_tpu.models.slam import Slam as JSlam
from cusift_tpu_torch.config import RansacConfig, SiftConfig, SlamConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
from cusift_tpu_torch.models.slam import Slam

torch.set_num_threads(2)

SIFT = dict(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
RANSAC = dict(num_hypotheses=512, inlier_thresh_3d=0.03)


@pytest.fixture(scope="module")
def seq():
    return planar_rgbd_sequence(n_frames=8, h=240, w=320, seed=2, motion_scale=0.6)


def _port(seq):
    return Slam(seq.intr, sift_cfg=SiftConfig(**SIFT), ransac_cfg=RansacConfig(**RANSAC),
                slam_cfg=SlamConfig(max_keyframes=16), device="cpu")


def _jax(seq):
    return JSlam(seq.intr, sift_cfg=JSiftConfig(**SIFT), ransac_cfg=JRansacConfig(**RANSAC),
                 slam_cfg=JSlamConfig(max_keyframes=16))


def test_port_restores_a_jax_checkpoint_and_keeps_tracking(tmp_path, seq):
    ref = _jax(seq)
    for f in range(4):
        ref.process_frame(seq.images[f], seq.depths[f])
    path = str(tmp_path / "jax.npz")
    ref.checkpoint(path)

    slam = _port(seq)
    slam.restore(path)
    r_ref, t_ref = ref.trajectory()
    r, t = slam.trajectory()
    np.testing.assert_allclose(r, r_ref, atol=1e-6)
    np.testing.assert_allclose(t, t_ref, atol=1e-6)
    s, rs = slam.state, ref.state
    assert s.n_kf == rs.n_kf and s.n_kf_total == rs.n_kf_total
    assert s.edge_i == [int(x) for x in rs.edge_i]
    assert (slam._seed, slam._key_ctr) == (ref._seed, ref._key_ctr)
    np.testing.assert_array_equal(s.kf_desc.numpy(), np.asarray(rs.kf_desc))
    rec = slam.process_frame(seq.images[4], seq.depths[4])
    assert rec["tracked"]
    assert len(slam.trajectory()[0]) == 5


def test_jax_restores_a_port_checkpoint(tmp_path, seq):
    slam = _port(seq)
    for f in range(3):
        slam.process_frame(seq.images[f], seq.depths[f])
    path = str(tmp_path / "port.npz")
    slam.checkpoint(path)
    ref = _jax(seq)
    ref.restore(path)
    for got, want in zip(ref.trajectory(), slam.trajectory()):
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert ref.state.n_kf == slam.state.n_kf

"""The port's numpy data twins (cusift_tpu_torch/data/synthetic.py,
data/evaluation.py) and frame pipeline (utils/pipeline.py) against the JAX
package.

* `se3_exp` (float64, rounded to float32) against the reference's float32
  `optim/lie.py:se3_exp`: 2e-7, a few float32 ulps.
* `planar_rgbd_sequence`: poses to float32 rounding (2e-7), the analytic
  depth maps to float32 rounding (relative 3e-7, zeros in the same
  places), the images within 1e-3 (cv2 rounds warp coordinates to 1/32
  px, the twin does not).
* `ba_problem` and `pose_ring`: the same draws, so every integer array is
  equal and every float array agrees to float32 rounding of the poses.
* The evaluation copy gives the reference's ATE and RPE to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.data import evaluation as jev
from cusift_tpu.data import synthetic as jsyn
from cusift_tpu.optim.lie import se3_exp as j_se3_exp
from cusift_tpu_torch.data import evaluation as tev
from cusift_tpu_torch.data import synthetic as tsyn
from cusift_tpu_torch.utils.pipeline import device_frames, pack_frame

torch.set_num_threads(2)


def test_numpy_se3_exp_matches_jax():
    rng = np.random.default_rng(4)
    xis = np.concatenate([rng.normal(scale=0.5, size=(20, 6)),
                          rng.normal(scale=1e-6, size=(5, 6)), np.zeros((1, 6))])
    for xi in xis:
        r, t = tsyn.se3_exp(xi)
        rj, tj = j_se3_exp(jnp.asarray(xi))
        assert r.dtype == np.float32 and t.dtype == np.float32
        np.testing.assert_allclose(r, np.asarray(rj), atol=2e-7, rtol=0)
        np.testing.assert_allclose(t, np.asarray(tj), atol=2e-7, rtol=0)


@pytest.mark.parametrize("kw", [dict(n_frames=8, h=240, w=320, seed=2, motion_scale=0.6),
                                dict(n_frames=5, h=120, w=160, seed=7, motion_scale=1.2,
                                     depth_noise=0.01)])
def test_planar_rgbd_sequence_matches_jax(kw):
    got = tsyn.planar_rgbd_sequence(**kw)
    ref = jsyn.planar_rgbd_sequence(**kw)
    np.testing.assert_allclose(got.poses_r, ref.poses_r, atol=2e-7, rtol=0)
    np.testing.assert_allclose(got.poses_t, ref.poses_t, atol=2e-7, rtol=0)
    np.testing.assert_array_equal(got.depths > 0, ref.depths > 0)
    np.testing.assert_allclose(got.depths, ref.depths, rtol=3e-7, atol=0)
    np.testing.assert_allclose(got.images, ref.images, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got.intr, ref.intr)
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)


def test_planar_rgbd_detail_bands_change_only_the_texture():
    """detail_octaves (the port's knob for a denser scene; 1 is the
    reference's texture) leaves the poses and depths exactly as they are."""
    kw = dict(n_frames=3, h=60, w=80, seed=4, detail=0.25)
    base = tsyn.planar_rgbd_sequence(**kw)
    np.testing.assert_array_equal(tsyn.planar_rgbd_sequence(**kw, detail_octaves=1).images,
                                  base.images)
    dense = tsyn.planar_rgbd_sequence(**kw, detail_octaves=3)
    for name in ("poses_r", "poses_t", "depths", "intr", "timestamps"):
        np.testing.assert_array_equal(getattr(dense, name), getattr(base, name))
    assert np.abs(dense.images - base.images).max() > 0.05


def test_ba_problem_and_pose_ring_match_jax():
    prob, truth = tsyn.ba_problem(seed=3, n_cams=6, n_pts=60, pixel_noise=0.25)
    rprob, rtruth = jsyn.ba_problem(seed=3, n_cams=6, n_pts=60, pixel_noise=0.25)
    for k in ("cam_idx", "pt_idx", "w", "intr", "points"):
        np.testing.assert_array_equal(prob[k], rprob[k])
    for k in ("poses_r", "poses_t"):
        np.testing.assert_allclose(prob[k], rprob[k], atol=3e-7, rtol=0)
    # pixels move with the poses' float32 rounding: 1e-4 px
    np.testing.assert_allclose(prob["uv"], rprob["uv"], atol=1e-4, rtol=0)
    ring, rring = tsyn.pose_ring(n=20, drift=0.02, seed=1), jsyn.pose_ring(n=20, drift=0.02, seed=1)
    for k in ("edge_i", "edge_j", "weight"):
        np.testing.assert_array_equal(ring[k], rring[k])
    for k in ("gt_r", "gt_t", "init_r", "init_t", "meas_r", "meas_t"):
        np.testing.assert_allclose(ring[k], rring[k], atol=1e-5, rtol=0)


def test_evaluation_copy_matches_reference():
    rng = np.random.default_rng(8)
    gt_r = np.stack([tsyn.se3_exp(x)[0] for x in rng.normal(scale=0.3, size=(12, 6))])
    gt_t = rng.normal(size=(12, 3)).astype(np.float32)
    est_r = np.stack([tsyn.se3_exp(x)[0] @ r for x, r in
                      zip(rng.normal(scale=0.01, size=(12, 6)), gt_r)])
    est_t = gt_t + rng.normal(scale=0.02, size=gt_t.shape).astype(np.float32)
    for scale in (False, True):
        assert tev.ate_rmse(est_r, est_t, gt_r, gt_t, scale) == pytest.approx(
            jev.ate_rmse(est_r, est_t, gt_r, gt_t, scale), abs=1e-9)
    np.testing.assert_allclose(tev.rpe(est_r, est_t, gt_r, gt_t, 2),
                               jev.rpe(est_r, est_t, gt_r, gt_t, 2), atol=1e-9)
    np.testing.assert_allclose(tev.camera_centers(gt_r, gt_t), jev.camera_centers(gt_r, gt_t))


def test_device_frames_yields_packed_frames_in_order():
    rng = np.random.default_rng(2)
    frames = [(rng.random((6, 8), dtype=np.float32), rng.random((6, 8), dtype=np.float32))
              for _ in range(5)]
    frames[2] = (frames[2][0], None)
    got = list(device_frames(iter(frames), "cpu"))
    assert len(got) == 5
    for g, (img, depth) in zip(got, frames):
        assert g.shape == (2, 6, 8) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), pack_frame(img, depth))
    assert not got[2][1].any()


def test_device_frames_forwards_producer_errors():
    def frames():
        yield np.zeros((2, 2), np.float32), np.zeros((2, 2), np.float32)
        raise OSError("frame 1 unreadable")

    it = device_frames(frames(), "cpu")
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)

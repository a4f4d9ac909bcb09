"""The port's stereo frontend (cusift_tpu_torch/ops/stereo.py,
models/stereo.py) against the JAX package and at the bounds of
tests/test_stereo.py.

* `stereo_depth` on the JAX package's features of one rectified pair
  (converted to tensors): `ok` equal but for slots whose JAX ratio lies
  within 1e-6 of the ratio threshold (counted, at most 1), depth within
  1e-6 relative where both are ok.
* `_extract_stereo_points`: both images in one `extract_batch` of 2,
  equal to `extract` of each image slot by slot; against the analytic
  left depth, >= 60 admissible matches with a median relative error
  < 0.02 (tests/test_stereo.py:31-65, 240x320, 384 keypoints).
* `StereoSlam` over the 10-frame scene: every frame tracked, metric ATE
  < 0.05 m with no alignment, path length within 5%
  (tests/test_stereo.py:68-86); chunk 3 against chunk 1, both ATE < 0.05
  (tests/test_stereo.py:125-146); a stereo chunk step's rows equal the
  sequential steps' bit for bit.
* `dist_ba=True` builds its mesh (a one-rank gloo group on the CPU), and a
  baseline <= 0 is refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import MatchConfig as JaxMatchConfig
from cusift_tpu.config import SiftConfig as JaxSiftConfig
from cusift_tpu.models.sift import extract as jax_extract
from cusift_tpu.ops.stereo import stereo_depth as jax_stereo_depth
from cusift_tpu_torch.config import MatchConfig, SiftConfig, SlamConfig
from cusift_tpu_torch.convert import to_numpy
from cusift_tpu_torch.data.evaluation import ate_rmse, trajectory_path_length
from cusift_tpu_torch.data.synthetic import two_plane_stereo_sequence
from cusift_tpu_torch.models.sift import extract
from cusift_tpu_torch.models.stereo import (StereoSlam, _extract_stereo_points,
                                            _stereo_chunk_step)
from cusift_tpu_torch.ops.stereo import stereo_depth

torch.set_num_threads(2)

SIFT_KW = dict(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
SIFT = SiftConfig(**SIFT_KW)
SLAM_CFG = SlamConfig(max_keyframes=16, loop_temporal_gap=50)


@pytest.fixture(scope="module")
def seq():
    return two_plane_stereo_sequence(n_frames=10, h=240, w=320, seed=4, motion_scale=0.7,
                                     amplitude=2.0, baseline=0.12)


def _pixels(x, y, h, w):
    return (np.clip(np.round(y).astype(int), 0, h - 1),
            np.clip(np.round(x).astype(int), 0, w - 1))


def test_stereo_depth_matches_jax(seq):
    jsift = JaxSiftConfig(**SIFT_KW)
    fl = jax_extract(jnp.asarray(seq.images_l[0]), jsift)
    fr = jax_extract(jnp.asarray(seq.images_r[0]), jsift)
    fx = float(seq.intr[0])
    ref_d, ref_ok = jax_stereo_depth(fl.desc, fl.valid, fl.x, fl.y, fr.desc, fr.valid,
                                     fr.x, fr.y, fx, seq.baseline, JaxMatchConfig())
    ref_d, ref_ok = np.asarray(ref_d), np.asarray(ref_ok)
    tl, tr = to_numpy(fl), to_numpy(fr)
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         (("dl", tl["desc"]), ("vl", tl["valid"]), ("xl", tl["x"]), ("yl", tl["y"]),
          ("dr", tr["desc"]), ("vr", tr["valid"]), ("xr", tr["x"]), ("yr", tr["y"]))}
    depth, ok = stereo_depth(t["dl"], t["vl"], t["xl"], t["yl"], t["dr"], t["vr"],
                             t["xr"], t["yr"], torch.tensor(np.float32(fx)),
                             torch.tensor(np.float32(seq.baseline)), MatchConfig())
    depth, ok = depth.numpy(), ok.numpy()
    assert ref_ok.sum() >= 60
    # the ratio test's margin: d1/d2 against the threshold, from the JAX
    # descriptors (unit vectors, d^2 = 2 - 2 s)
    sim = tl["desc"] @ tr["desc"].T
    sim = np.where(tr["valid"][None], sim, -np.inf)
    top2 = -np.sort(-sim, axis=1)[:, :2]
    d = np.sqrt(np.maximum(2.0 - 2.0 * top2, 0.0))
    near = np.abs(d[:, 0] / np.maximum(d[:, 1], 1e-12) - MatchConfig().ratio_thresh) < 1e-6
    differ = ok != ref_ok
    assert not (differ & ~near).any()
    assert differ.sum() <= 1
    both = ok & ref_ok
    np.testing.assert_allclose(depth[both], ref_d[both], rtol=1e-6, atol=0)
    assert not depth[~ok].any()


def test_extract_stereo_points_per_image_and_metric(seq):
    img_l, img_r = (torch.from_numpy(a) for a in (seq.images_l[0], seq.images_r[0]))
    intr = torch.from_numpy(seq.intr)
    fl, pts, dok = _extract_stereo_points(img_l, img_r, intr,
                                          torch.tensor(np.float32(seq.baseline)), SIFT,
                                          MatchConfig())
    one = extract(img_l, SIFT)
    for name, a, b in zip(one._fields, fl, one):
        assert torch.equal(a, b), name
    fr = extract(img_r, SIFT)
    depth, ok = stereo_depth(one.desc, one.valid, one.x, one.y, fr.desc, fr.valid,
                             fr.x, fr.y, intr[0], torch.tensor(np.float32(seq.baseline)))
    assert torch.equal(ok, dok) and torch.equal(pts[:, 2], depth)
    dok = dok.numpy()
    assert dok.sum() >= 60, dok.sum()
    gt = seq.depths[0][_pixels(fl.x.numpy(), fl.y.numpy(), 240, 320)]
    have = dok & (gt > 0.05)
    rel = np.abs(pts[:, 2].numpy()[have] - gt[have]) / gt[have]
    assert np.median(rel) < 0.02, np.median(rel)


def test_stereo_slam_tracks_metric_scale(seq):
    slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=SIFT, slam_cfg=SLAM_CFG, device="cpu")
    recs = slam.run(zip(seq.images_l, seq.images_r))
    assert len(recs) == 10
    assert sum(r.get("tracked", True) for r in recs) == 10
    est_r, est_t = slam.trajectory()
    ate = ate_rmse(est_r, est_t, seq.poses_r, seq.poses_t)       # metric: no scale
    assert ate < 0.05, f"metric ATE {ate:.4f} m"
    len_est = trajectory_path_length(est_r, est_t)[-1]
    len_gt = trajectory_path_length(seq.poses_r, seq.poses_t)[-1]
    assert abs(len_est / len_gt - 1.0) < 0.05, (len_est, len_gt)


def test_stereo_chunked_run_matches_sequential(seq):
    ates = []
    for chunk in (1, 3):
        slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=SIFT, slam_cfg=SLAM_CFG,
                          device="cpu")
        recs = slam.run(zip(seq.images_l, seq.images_r), chunk=chunk)
        assert len(recs) == 10
        assert sum(r.get("tracked", True) for r in recs) == 10
        ates.append(ate_rmse(*slam.trajectory(), seq.poses_r, seq.poses_t))
    assert max(ates) < 0.05, ates


def test_stereo_chunk_rows_equal_frame_steps(seq):
    """One extract_batch over the chunk's 2N images, then frame by frame:
    row i equals the sequential step of pair i with the same generator."""
    slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=SIFT, slam_cfg=SLAM_CFG, device="cpu")
    slam.process_frame(seq.images_l[0], seq.images_r[0])
    _, kd, kv, kp = slam._ref_cache
    chunk = torch.from_numpy(np.stack([np.stack([seq.images_l[i], seq.images_r[i]])
                                       for i in (2, 3, 4)]))
    feats, pts, rows = _stereo_chunk_step(chunk, slam.intr, slam.baseline, kd, kv, kp, SIFT,
                                          slam.match_cfg, slam.ransac_cfg, slam._next_keys(3))
    slam._key_ctr -= 3
    for i in range(3):
        f, p, row = slam._sense_step(chunk[i, 0], chunk[i, 1], kd, kv, kp, slam._next_key())
        assert torch.equal(row, rows[i]) and torch.equal(p, pts[i])
        assert torch.equal(f.x, feats.x[i]) and torch.equal(f.desc, feats.desc[i])
    assert (rows[:, 1] == 1).all()


def test_stereo_dist_ba_raises(seq):
    """dist_ba no longer raises: StereoSlam inherits Slam's distributed
    window BA over a mesh of the group's ranks."""
    import torch.distributed as dist
    try:
        slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=SIFT, dist_ba=True, device="cpu")
        assert slam._ba_mesh.shape == (1, 1) and not slam._fused_events
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("baseline", [0.0, -0.12])
def test_stereo_refuses_a_baseline_not_above_zero(seq, baseline):
    with pytest.raises(ValueError, match="baseline"):
        StereoSlam(seq.intr, baseline, sift_cfg=SIFT, device="cpu")

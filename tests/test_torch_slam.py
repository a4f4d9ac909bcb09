"""The port's RGB-D SLAM loop (cusift_tpu_torch/models/slam.py) at the
bounds of tests/test_slam.py, and its parts against the JAX package.

* `_kf_scores` (blocked batched matmul + max) equals the reference's
  einsum + max to 1e-6, with the same argmax, across block boundaries and
  with inactive and invalid slots.
* `select_victim` (models/evict.py, a numpy copy) picks the reference's
  victim in every mode.
* Outcomes at the reference's bounds: ATE under 0.02 m on the 8-frame
  sequence, relocalisation onto the right keyframe, eviction bookkeeping
  exact to 1e-6, checkpoint/resume, blackout recovery, and tracking that
  continues once eviction fires.
* The package's rules: numpy frames go to the GPU unless device="cpu" is
  passed (without a GPU that is an error), and the two options that wait
  for later work raise NotImplementedError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.models import evict as jevict
from cusift_tpu.models import slam as jslam
from cusift_tpu_torch.config import RansacConfig, SiftConfig, SlamConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
from cusift_tpu_torch.models import evict as tevict
from cusift_tpu_torch.models.slam import Slam, _kf_scores

torch.set_num_threads(2)

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
RANSAC = RansacConfig(num_hypotheses=512, inlier_thresh_3d=0.03)


@pytest.fixture(scope="module")
def seq():
    return planar_rgbd_sequence(n_frames=8, h=240, w=320, seed=2, motion_scale=0.6)


def _unit(rng, shape):
    x = rng.normal(size=shape + (128,)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("limit", [None, 0, 5, 17, 40])
def test_kf_scores_match_jax(limit):
    rng = np.random.default_rng(3)
    kf, n = 40, 48
    kd = _unit(rng, (kf, n))
    kv = rng.random((kf, n)) > 0.2
    kv[7] = False                                    # a keyframe with no valid slot
    q = kd[11] + rng.normal(scale=0.05, size=(n, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qv = rng.random(n) > 0.1
    active = np.arange(kf) < (kf if limit is None else limit)
    active[3] = False
    ref = np.asarray(jslam._kf_scores(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(kd),
                                      jnp.asarray(kv), jnp.asarray(active)))
    got = _kf_scores(*(torch.from_numpy(a) for a in (q, qv, kd, kv, active)),
                     limit=limit).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=1e-6, rtol=0)
    if fin.any():
        assert int(np.argmax(got)) == int(np.argmax(ref))


def test_select_victim_matches_reference():
    rng = np.random.default_rng(6)
    n = 12
    pr = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)]).astype(np.float32)
    pt = rng.normal(size=(n, 3)).astype(np.float32)
    edges = [(i, i + 1, 1.0) for i in range(n - 1)] + [(2, 9, 2.0), (4, 0, 2.0)]
    for mode in ("redundant", "oldest", "none"):
        for guard, pinned in ((2, -1), (5, -1), (3, 4), (11, -1), (3, 1)):
            got = tevict.select_victim(mode, pr, pt, n, guard, edges, pinned)
            ref = jevict.select_victim(mode, pr, pt, n, guard, edges, pinned)
            assert got == ref, (mode, guard, pinned)


def test_slam_sequence_ate(seq):
    slam = Slam(seq.intr, sift_cfg=SIFT, ransac_cfg=RANSAC,
                slam_cfg=SlamConfig(max_keyframes=16, kf_min_inliers=120,
                                    kf_max_translation=0.12, kf_max_rotation=0.12,
                                    loop_temporal_gap=3), device="cpu")
    for f in range(len(seq.images)):
        rec = slam.process_frame(seq.images[f], seq.depths[f])
        assert rec["kpts"] > 0
    assert slam.state.n_kf >= 2
    ate = slam.ate(seq.poses_r, seq.poses_t)
    assert ate < 0.02, f"ATE RMSE {ate:.4f} m"


def test_event_hook_sees_each_fused_event(seq):
    """on_event reports each fused keyframe event dispatched, enqueued and
    applied, in that order, with its window BA's costs and its closure."""
    slam = Slam(seq.intr, sift_cfg=SIFT, ransac_cfg=RANSAC,
                slam_cfg=SlamConfig(max_keyframes=16, kf_max_translation=0.03,
                                    kf_max_rotation=0.03, loop_temporal_gap=1),
                device="cpu")
    seen = []
    slam.on_event = lambda stage, x: seen.append((stage, x))
    recs = slam.run(zip(seq.images, seq.depths))
    n_events = sum(r["keyframe"] for r in recs[1:])
    assert n_events >= 3
    assert [s for s, _ in seen] == ["dispatch", "enqueued", "applied"] * n_events
    applied = [x for s, x in seen if s == "applied"]
    assert [a["slot"] for a in applied] == [x for s, x in seen if s == "dispatch"]
    assert sum(a["accept"] for a in applied) == slam.state.n_closures
    for a in applied:
        c0, c1 = a["ba_cost"]
        assert a["apply_ms"] >= 0 and (c1 <= c0 if a["window"] else c0 == c1 == 0)


def test_slam_checkpoint_resume(tmp_path, seq):
    def build():
        return Slam(seq.intr, sift_cfg=SIFT, ransac_cfg=RANSAC,
                    slam_cfg=SlamConfig(max_keyframes=16), device="cpu")

    slam = build()
    for f in range(4):
        slam.process_frame(seq.images[f], seq.depths[f])
    path = str(tmp_path / "ckpt.npz")
    slam.checkpoint(path)
    slam2 = build()
    slam2.restore(path)
    r1, t1 = slam.trajectory()
    r2, t2 = slam2.trajectory()
    np.testing.assert_allclose(t1, t2, atol=1e-7)
    np.testing.assert_allclose(r1, r2, atol=1e-7)
    assert slam2._key_ctr == slam._key_ctr
    rec = slam2.process_frame(seq.images[4], seq.depths[4])
    assert rec["tracked"]


def _synthetic_keyframe(rng, n=SIFT.total_kpts):
    desc = torch.from_numpy(_unit(rng, (n,)))
    pts = torch.from_numpy(rng.uniform([-1, -1, 1], [1, 1, 4], (n, 3)).astype(np.float32))
    return desc, torch.ones(n, dtype=torch.bool), pts


def test_relocalisation_retrieves_and_verifies():
    """A lost frame seeing keyframe 0's content relocalises onto it (not the
    excluded failed reference) with ~identity pose; unrelated content is
    rejected by the strict verification gate."""
    rng = np.random.default_rng(0)
    slam = Slam(np.array([500.0, 500, 160, 120], np.float32), sift_cfg=SIFT,
                slam_cfg=SlamConfig(max_keyframes=8), device="cpu")
    d0, v0, p0 = _synthetic_keyframe(rng)
    d1, v1, p1 = _synthetic_keyframe(rng)
    for d, v, p in ((d0, v0, p0), (d1, v1, p1)):
        slam._add_keyframe(d, v, p, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    res = slam._try_relocalise(d0, v0, p0, ref=1)
    assert res is not None
    cand, rel_r, rel_t, inl = res
    assert cand == 0
    assert inl >= slam.cfg.loop_min_inliers
    np.testing.assert_allclose(rel_r, np.eye(3), atol=1e-3)
    np.testing.assert_allclose(rel_t, 0.0, atol=1e-2)
    dq, vq, pq = _synthetic_keyframe(rng)
    assert slam._try_relocalise(dq, vq, pq, ref=1) is None


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def test_keyframe_eviction_splices_edges_and_freezes_frames():
    """Removing slot v leaves every reconstructed pose unchanged (frames on
    v baked to absolutes), splices v's in/out edges into one composed
    constraint, and shifts the ring and higher indices down."""
    sift = SiftConfig(max_kpts=64, max_kpts_per_octave=64, num_octaves=2)
    slam = Slam(np.array([200.0, 200.0, 160.0, 120.0], np.float32), sift_cfg=sift,
                slam_cfg=SlamConfig(max_keyframes=8, local_ba_window=3), device="cpu")
    s = slam.state
    n = sift.total_kpts
    poses = []
    for i in range(5):
        r, t = _rot_z(0.1 * i), np.array([i, 0.2 * i, 0], np.float32)
        poses.append((r, t))
        slam._add_keyframe(torch.full((n, 128), float(i)), torch.zeros(n, dtype=torch.bool),
                           torch.zeros((n, 3)), r, t)
        if i:
            rp, tp = poses[i - 1]
            m_r = rp @ r.T
            slam._add_edge(i - 1, i, m_r, tp - m_r @ t, 1.0)
        s.traj_ref.append(i)
        s.traj_rel_r.append(_rot_z(0.01 * i))
        s.traj_rel_t.append(np.array([0.0, 0.0, 0.1 * i], np.float32))
        s.traj_ok.append(True)
    before_r, before_t = slam.trajectory()

    slam._remove_keyframe_slot(2)

    after_r, after_t = slam.trajectory()
    np.testing.assert_allclose(after_r, before_r, atol=1e-6)
    np.testing.assert_allclose(after_t, before_t, atol=1e-6)
    assert s.n_kf == 4
    assert s.traj_ref == [0, 1, -1, 2, 3]
    assert sorted(zip(s.edge_i, s.edge_j)) == [(0, 1), (1, 2), (2, 3)]
    k = list(zip(s.edge_i, s.edge_j)).index((1, 2))
    r1, t1 = poses[1]
    r3, t3 = poses[3]
    m_r = r1 @ r3.T
    np.testing.assert_allclose(s.meas_r[k], m_r, atol=1e-6)
    np.testing.assert_allclose(s.meas_t[k], t1 - m_r @ t3, atol=1e-6)
    np.testing.assert_allclose(s.kf_pose_r[2], poses[3][0], atol=1e-6)
    np.testing.assert_allclose(s.kf_pose_t[3], poses[4][1], atol=1e-6)
    # the device ring moved with the poses; the victim parks in the top slot
    assert [float(s.kf_desc[i, 0, 0]) for i in range(5)] == [0.0, 1.0, 3.0, 4.0, 0.0]
    assert float(s.kf_desc[7, 0, 0]) == 2.0


def test_blackout_recovery():
    """Noise frames lose tracking; real frames afterwards track again."""
    seq = planar_rgbd_sequence(6, 240, 320, motion_scale=0.5, seed=6)
    rs = np.random.default_rng(0)
    slam = Slam(seq.intr, sift_cfg=SIFT, slam_cfg=SlamConfig(max_keyframes=16), device="cpu")
    for i in range(4):
        slam.process_frame(seq.images[i], seq.depths[i])
    for _ in range(2):
        rec = slam.process_frame(rs.random((240, 320)).astype(np.float32) * 0.05,
                                 np.zeros((240, 320), np.float32))
        assert not rec["tracked"]
    assert slam.process_frame(seq.images[4], seq.depths[4])["tracked"]
    slam.process_frame(seq.images[5], seq.depths[5])
    assert slam.metrics[-1]["tracked"]


def test_eviction_keeps_tracking():
    """A ring of 6 on a 14-frame orbit: eviction fires, every frame still
    tracks, and the reconstructed trajectory stays finite."""
    seq = planar_rgbd_sequence(14, 240, 320, motion_scale=0.9, seed=5)
    slam = Slam(seq.intr, sift_cfg=SIFT, ransac_cfg=RANSAC,
                slam_cfg=SlamConfig(max_keyframes=6, local_ba_window=3,
                                    kf_max_translation=0.06, kf_max_rotation=0.06,
                                    loop_temporal_gap=2), device="cpu")
    recs = slam.run(zip(seq.images, seq.depths))
    assert len(recs) == 14 and all(r.get("tracked", True) for r in recs)
    assert slam.state.n_kf == 6 and slam.state.n_kf_total > 6
    assert any(ref == -1 for ref in slam.state.traj_ref)
    est_r, est_t = slam.trajectory()
    assert np.isfinite(est_t).all()
    assert slam.ate(seq.poses_r, seq.poses_t) < 0.05


def test_numpy_frames_without_gpu_raise(monkeypatch, seq):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Slam(seq.intr, sift_cfg=SIFT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Slam(seq.intr, sift_cfg=SIFT, device="cuda")
    slam = Slam(seq.intr, sift_cfg=SIFT, device="cpu")
    assert slam.state.kf_desc.device.type == "cpu"
    assert slam.process_frame(seq.images[0], seq.depths[0])["keyframe"]


def test_unported_options_raise(seq):
    with pytest.raises(NotImplementedError, match="dist_ba"):
        Slam(seq.intr, sift_cfg=SIFT, dist_ba=True, device="cpu")
    slam = Slam(seq.intr, sift_cfg=SIFT, device="cpu")
    with pytest.raises(NotImplementedError, match="chunk"):
        slam.run(zip(seq.images, seq.depths), chunk=3)


def test_anchor_knob_threads_to_window_ba(monkeypatch):
    """`SlamConfig.local_ba_anchor` reaches `window_ba(anchor=...)`, and
    "union" takes the split event form (tests/test_local_ba.py's SLAM
    half of test_anchor_knob_threads_to_window_ba)."""
    import cusift_tpu_torch.models.slam as slam_mod

    seen = []

    def recorder(kd, kv, kp, r0, t0, intr, mask, *a, **kw):
        seen.append(kw.get("anchor", "newest"))
        z = torch.zeros(())
        return r0, t0, z, z

    monkeypatch.setattr(slam_mod, "window_ba", recorder)
    intr = np.array([100.0, 100.0, 80.0, 60.0], np.float32)
    for anchor, fused in (("union", False), ("newest", True)):
        s = Slam(intr, sift_cfg=SIFT, device="cpu",
                 slam_cfg=SlamConfig(max_keyframes=8, local_ba_window=3,
                                     local_ba_anchor=anchor))
        assert s._fused_events is fused
        s.state.n_kf = 3
        s._local_ba()
    assert seen == ["union", "newest"]

"""The port's monocular VO (cusift_tpu_torch/models/odometry.py) at the
bars of tests/test_odometry.py, tests/test_pnp_rescue.py and
tests/test_vo_sequence.py (not-slow tier), and its host-side numpy against
the JAX package's.

* The PnP rescue after the fetch equals the reference's always-on
  selection field for field (bit-equal on the CPU), on a rescued pair and
  on a healthy one.
* Host-side numpy (Sim(3) edge splicing, the gate observables and
  decisions) against the JAX package's code on the same arrays: equal.
* The port's checkpoint/resume reproduces the uninterrupted run to 1e-5.
* `pad_to_tier` equals the reference's, and `MonoVO(pad_to_tier=True)`
  keeps every feature inside the content.

tests/test_pnp_rescue.py's 8-frame scene is bimodal at its first pair:
essential RANSAC lands on the true motion (t . t_gt = 0.84) or on a
flipped one (-0.45) depending on the sample stream, in 21 of 48 streams in
each package (measured on the CPU); the reference's key for that pair lands
on the true one, the port's default stream on the flipped one.
`test_first_pair_is_bimodal` holds that the port shares the bimodality,
and the depth-transfer test runs with a RANSAC seed whose first pair lands
on the true motion (ROADMAP queue 3).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from cusift_tpu.config import SiftConfig as JSiftConfig
from cusift_tpu.config import VOConfig as JVOConfig
from cusift_tpu.models import odometry as jodo
from cusift_tpu_torch.config import RansacConfig, SiftConfig, VOConfig
from cusift_tpu_torch.data.evaluation import ate_rmse, trajectory_path_length
from cusift_tpu_torch.data.synthetic import two_plane_sequence
from cusift_tpu_torch.models import odometry as todo
from cusift_tpu_torch.models.odometry import MonoVO, _masked_median, pair_step
from cusift_tpu_torch.ops.ransac import step_generators

torch.set_num_threads(2)

SIFT_PAIR = dict(max_kpts=768, max_kpts_per_octave=512, num_octaves=4, upscale=False)
SIFT = dict(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
SIFT_CKPT = dict(max_kpts=256, max_kpts_per_octave=192, num_octaves=3)
# the RANSAC seed of the depth-transfer test: its first pair lands on the
# true motion (see the module docstring)
RESCUE_SEED = 2


def _vo(seq, sift=SIFT, **kw):
    return MonoVO(seq.intr, sift_cfg=SiftConfig(**sift), device="cpu", **kw)


def test_masked_median():
    v = torch.tensor([5.0, 1.0, 9.0, 3.0, 7.0])
    m = torch.tensor([True, False, True, True, True])
    assert float(_masked_median(v, m)) == 5.0
    assert np.isinf(float(_masked_median(v, torch.zeros(5, dtype=torch.bool))))


def test_entry_points_raise_what_is_not_ported():
    intr = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    with pytest.raises(NotImplementedError, match="item 11"):
        MonoVO(intr, vo_cfg=VOConfig(map_anchor=True), device="cpu")
    # dist_ba is ported: without a process group it makes a one-rank one
    import torch.distributed as dist
    try:
        vo = MonoVO(intr, dist_ba=True, device="cpu")
        assert vo._ba_mesh is not None and vo._ba_mesh.shape == (1, 1)
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---- the reference tests' bars on the port ----

@pytest.fixture(scope="module")
def seq6():
    return two_plane_sequence(n_frames=6, h=240, w=320, seed=3, near=3.0, far=6.0,
                              motion_scale=0.6)


def test_mono_vo_recovers_trajectory_up_to_scale(seq6):
    vo = _vo(seq6, SIFT_PAIR, ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3))
    est_r, est_t = vo.run(list(seq6.images))
    assert len(est_r) == 6
    assert all(s["ok"] for s in vo.stats)
    assert all(s["inliers"] > 60 for s in vo.stats)
    assert all(s["scale_common"] >= 8 for s in vo.stats[1:])
    for k in (1, 3, 5):
        r_rel_est = est_r[k] @ est_r[k - 1].T
        r_rel_gt = seq6.poses_r[k] @ seq6.poses_r[k - 1].T
        assert np.abs(r_rel_est - r_rel_gt).max() < 0.02
    ratios = []
    for k in range(1, 6):
        te = est_t[k] - (est_r[k] @ est_r[k - 1].T) @ est_t[k - 1]
        tg = seq6.poses_t[k] - (seq6.poses_r[k] @ seq6.poses_r[k - 1].T) @ seq6.poses_t[k - 1]
        ratios.append(np.linalg.norm(te) / max(np.linalg.norm(tg), 1e-9))
    ratios = np.array(ratios)
    assert ratios.std() / ratios.mean() < 0.15
    ate = ate_rmse(est_r, est_t, seq6.poses_r, seq6.poses_t, with_scale=True)
    assert ate < 0.09 * trajectory_path_length(seq6.poses_r, seq6.poses_t)[-1]


def test_mono_vo_windowed_ba_consistent(seq6):
    def run(w):
        vo = _vo(seq6, SIFT_PAIR, ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3),
                 ba_window=w, ba_every=1)
        er, et = vo.run(list(seq6.images))
        return ate_rmse(er, et, seq6.poses_r, seq6.poses_t, with_scale=True), vo

    ate_raw, _ = run(0)
    ate_ba, vo_ba = run(4)
    c0, c1 = vo_ba._last_ba
    assert c1 < c0 * 0.2
    path = trajectory_path_length(seq6.poses_r, seq6.poses_t)[-1]
    assert ate_ba <= max(2.5 * ate_raw, 0.05 * path)


def _rescue_seq(n_frames):
    """tests/test_pnp_rescue.py's scenes (the sweep's per-frame motion
    depends on n_frames)."""
    return two_plane_sequence(n_frames=n_frames, h=240, w=320, seed=7, motion_scale=0.8)


def test_pnp_rescue_supplies_pose_when_essential_fails():
    seq = _rescue_seq(6)
    vo = _vo(seq)
    for img in seq.images[:3]:
        vo.process(img)
    assert vo.stats[-1]["ok"] and not vo.stats[-1]["pnp_ok"]
    vo.ransac_cfg = replace(vo.ransac_cfg, inlier_thresh_epi=1e-9)
    for img in seq.images[3:]:
        vo.process(img)
    rescued = vo.stats[2:]
    assert all(s["ok"] for s in rescued), [s["ok"] for s in rescued]
    assert all(s["pnp_ok"] for s in rescued)
    assert all(s["pnp_inliers"] >= 8 for s in rescued)
    er, et = vo.trajectory()
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
    assert ate < 0.05 * trajectory_path_length(seq.poses_r, seq.poses_t)[-1]


def test_pnp_rescue_off_restores_carry_behaviour():
    seq = _rescue_seq(5)
    vo = _vo(seq, vo_cfg=VOConfig(pnp_rescue=False, kf_every=100))
    for img in seq.images[:3]:
        vo.process(img)
    vo.ransac_cfg = replace(vo.ransac_cfg, inlier_thresh_epi=1e-9)
    for img in seq.images[3:]:
        vo.process(img)
    assert not vo.stats[-1]["ok"] and not vo.stats[-1]["pnp_ok"]


@pytest.fixture(scope="module")
def seq_rescue():
    return _rescue_seq(8)


def _first_pair_cos(seq, generators):
    cfg = SiftConfig(**SIFT)
    from cusift_tpu_torch.models.sift import extract
    fa = extract(torch.from_numpy(seq.images[0]), cfg)
    out, _ = pair_step(fa.desc, fa.valid, torch.stack([fa.x, fa.y], -1),
                       torch.zeros(cfg.total_kpts), torch.from_numpy(seq.images[1]),
                       torch.from_numpy(seq.intr), torch.ones(()), cfg,
                       generators=generators)
    rg = seq.poses_r[1] @ seq.poses_r[0].T
    tg = seq.poses_t[1] - rg @ seq.poses_t[0]
    t = out.t_rel.numpy()
    return float(t @ tg / (np.linalg.norm(t) * np.linalg.norm(tg)))


def test_first_pair_is_bimodal(seq_rescue):
    """The 8-frame rescue scene's first pair: the port's streams land on
    both the true and the flipped motion, as the reference's keys do; the
    default stream (seed 0) on the flipped one, RESCUE_SEED's on the true."""
    cos = [_first_pair_cos(seq_rescue, step_generators("cpu", 0, c, 2)) for c in range(12)]
    assert sum(c > 0.8 for c in cos) >= 2 and sum(c < -0.4 for c in cos) >= 2, cos
    assert all(c > 0.8 or c < -0.4 for c in cos), cos
    assert cos[1] < -0.4                       # MonoVO's first pair: counter 1
    assert _first_pair_cos(seq_rescue, step_generators("cpu", RESCUE_SEED, 1, 2)) > 0.8


def test_pnp_rescue_transfers_depth_chain(seq_rescue):
    seq = seq_rescue
    vo = _vo(seq, ransac_cfg=RansacConfig(seed=RESCUE_SEED))
    for img in seq.images[:3]:
        vo.process(img)
    healthy = vo.ransac_cfg
    vo.ransac_cfg = replace(healthy, inlier_thresh_epi=1e-9)
    vo.process(seq.images[3])
    assert vo.stats[-1]["pnp_ok"]
    vo.ransac_cfg = healthy
    vo.process(seq.images[4])
    s = vo.stats[-1]
    assert s["ok"] and not s["pnp_ok"]
    assert s["scale_common"] >= 8, s


@pytest.mark.parametrize("sabotage", [True, False])
def test_rescue_after_fetch_equals_always_rescue(seq_rescue, sabotage):
    """The rescue as a host-gated second step equals the reference's
    always-on selection: `_pnp_rescue` applied unconditionally."""
    seq = seq_rescue
    vo = _vo(seq)
    for img in seq.images[:3]:
        vo.process(img)
    cfg = replace(vo.ransac_cfg, inlier_thresh_epi=1e-9) if sabotage else vo.ransac_cfg
    f, img = vo._feats, torch.from_numpy(seq.images[3])
    args = (f.desc, f.valid, torch.stack([f.x, f.y], -1), vo._depth, img, vo.intr, vo._scale,
            vo.sift_cfg, vo.match_cfg, cfg)
    gated, row = pair_step(*args, step_generators("cpu", 5, 7, 2))
    gens = step_generators("cpu", 5, 7, 2)
    core, rescue = todo._pair_core(*args, gens[0])
    always = todo._pnp_rescue(core, rescue, vo._scale, cfg, gens[1])
    assert bool(rescue.try_pnp) == sabotage == bool(row[-1] > 0.5)
    assert bool(always.pnp_used) == sabotage
    for name in todo.PairOdometry._fields:
        a, b = getattr(gated, name), getattr(always, name)
        for x, y in (zip(a, b) if name == "feats" else ((a, b),)):
            assert torch.equal(x, y), name
    np.testing.assert_array_equal(row, todo._row(always, rescue.try_pnp).numpy())


@pytest.fixture(scope="module")
def seq14():
    return two_plane_sequence(n_frames=14, h=240, w=320, seed=7, motion_scale=0.8,
                              amplitude=2.0)


def test_keyframe_ring_overflow_graceful(seq14):
    vo = _vo(seq14, vo_cfg=VOConfig(max_keyframes=3, kf_every=2, loop_temporal_gap=50,
                                    kf_evict="none"))
    er, _ = vo.run(iter(seq14.images))
    assert vo.n_kf == 3 and len(er) == 14
    assert sum(s["ok"] for s in vo.stats) >= 0.8 * len(vo.stats)


def test_keyframe_ring_overflow_evicts_and_keeps_inserting(seq14):
    vo = _vo(seq14, vo_cfg=VOConfig(max_keyframes=5, kf_every=2, loop_temporal_gap=50))
    er, et = vo.run(iter(seq14.images))
    assert vo.n_kf == 5
    assert vo._kf_frame[-1] >= 10
    assert len(vo._kf_frame) == 5 and sorted(vo._kf_frame) == vo._kf_frame
    assert len(er) == 14 and np.isfinite(et).all()
    assert sum(s["ok"] for s in vo.stats) >= 0.8 * len(vo.stats)


def test_keyframe_referenced_tracking_mode():
    seq = two_plane_sequence(n_frames=16, h=240, w=320, seed=3, motion_scale=0.9,
                             path="loop", amplitude=6.0)
    vo = _vo(seq, vo_cfg=VOConfig(track_ref="keyframe", kf_every=4, loop_temporal_gap=100))
    er, et = vo.run(iter(seq.images))
    assert len(er) == 16
    assert sum(s["ok"] for s in vo.stats) >= 0.85 * len(vo.stats)
    assert vo._kf_frame[0] == 0 and vo._kf_frame[1] == 1
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
    assert ate < 0.2 * trajectory_path_length(seq.poses_r, seq.poses_t)[-1]
    assert np.isfinite(et).all()


# ---- host-side numpy against the JAX package's code ----

def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _splice_setup(vo):
    vo._kf_pose_r = np.zeros((8, 3, 3), np.float32)
    vo._kf_pose_t = np.zeros((8, 3), np.float32)
    poses = []
    for i in range(5):
        r, t = _rot_z(0.1 * i), np.array([i, 0.1 * i, 0], np.float32)
        poses.append((r, t))
        vo._kf_pose_r[i], vo._kf_pose_t[i] = r, t
        vo._kf_frame.append(2 * i)
        if i:
            rp, tp = poses[i - 1]
            m_r = rp @ r.T
            vo._edges.append((i - 1, i, m_r, tp - m_r @ t, 1.0 + 0.1 * i, 1.0))
    vo.n_kf = 5
    vo._frame_ref = [0, 1, 2, 2, 3, 4]
    return poses


def test_remove_keyframe_slot_splices_sim3_edges():
    intr = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    vo = MonoVO(intr, sift_cfg=SiftConfig(**SIFT), device="cpu",
                vo_cfg=VOConfig(max_keyframes=8, loop_temporal_gap=50))
    ref = jodo.MonoVO(intr, sift_cfg=JSiftConfig(**SIFT),
                      vo_cfg=JVOConfig(max_keyframes=8, loop_temporal_gap=50))
    poses = _splice_setup(vo)
    _splice_setup(ref)
    vo._remove_keyframe_slot(2)
    ref._remove_keyframe_slot(2)
    assert vo.n_kf == ref.n_kf == 4
    assert vo._frame_ref == ref._frame_ref == [0, 1, 1, 1, 2, 3]
    assert vo._kf_frame == ref._kf_frame == [0, 2, 6, 8]
    assert [e[:2] for e in vo._edges] == [e[:2] for e in ref._edges]
    for e, er in zip(vo._edges, ref._edges):
        for a, b in zip(e[2:], er[2:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    spliced = [e for e in vo._edges if (e[0], e[1]) == (1, 2)][0]
    r12 = poses[1][0] @ poses[2][0].T
    t12 = poses[1][1] - r12 @ poses[2][1]
    r23 = poses[2][0] @ poses[3][0].T
    t23 = poses[2][1] - r23 @ poses[3][1]
    np.testing.assert_allclose(spliced[2], r12 @ r23, atol=1e-6)
    np.testing.assert_allclose(spliced[3], 1.2 * (r12 @ t23) + t12, atol=1e-5)
    assert abs(spliced[4] - 1.2 * 1.3) < 1e-6
    np.testing.assert_array_equal(vo._kf_pose_r, ref._kf_pose_r)
    np.testing.assert_array_equal(vo._kf_pose_t, ref._kf_pose_t)


def test_corr_inheritance_on_insert():
    intr = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    vo = MonoVO(intr, sift_cfg=SiftConfig(**SIFT), device="cpu",
                vo_cfg=VOConfig(max_keyframes=8, loop_temporal_gap=50))
    n = vo.sift_cfg.total_kpts
    from cusift_tpu_torch.convert import unpack_features
    vo._feats = unpack_features(np.zeros((n, 136), np.float32), "cpu")
    vo._depth = torch.zeros(n)
    assert vo._insert_keyframe()
    cr = np.broadcast_to(np.eye(3, dtype=np.float32), (8, 3, 3)).copy()
    ct = np.zeros((8, 3), np.float32)
    cs = np.ones(8, np.float32)
    cr[0], ct[0], cs[0] = _rot_z(0.3), np.array([1.0, 2.0, 3.0], np.float32), 2.0
    vo._corr = (cr, ct, cs)
    r1, t1 = _rot_z(0.1), np.array([0.5, 0.0, 0.1], np.float32)
    vo.poses_r.append(r1)
    vo.poses_t.append(t1)
    assert vo._insert_keyframe()
    vo._frame_ref = [0, 1]
    cr2, ct2, cs2 = vo._corr
    np.testing.assert_allclose(cr2[1], r1 @ cr[0], atol=1e-6)
    np.testing.assert_allclose(ct2[1], r1 @ ct[0] + t1, atol=1e-6)
    assert cs2[1] == cs[0]
    rs, ts = vo.trajectory()
    np.testing.assert_allclose(rs[1], r1 @ cr[0], atol=1e-6)
    np.testing.assert_allclose(ts[1], r1 @ (ct[0] / cs[0]) + t1 / cs[0], atol=1e-6)


def test_speed_dispersion_gate_observable():
    rng = np.random.default_rng(0)
    n = 20
    frames = list(range(0, 4 * n, 4))
    pose_r = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    cx = np.cumsum(np.exp(np.cumsum(rng.normal(0, 0.08, n))))
    pose_t = np.zeros((n, 3), np.float32)
    pose_t[:, 0] = -cx
    good = (cx / np.arange(1, n + 1)).astype(np.float32)
    bad = np.ones(n, np.float32)
    bad[n // 2:] = 8.0
    sig = {}
    for name, scales in (("raw", None), ("good", good), ("bad", bad)):
        sig[name] = MonoVO._speed_dispersion(pose_r, pose_t, scales, frames)
        assert sig[name] == jodo.MonoVO._speed_dispersion(pose_r, pose_t, scales, frames)
    assert sig["good"] < 0.25 * sig["raw"]
    assert sig["bad"] > 1.5 * sig["raw"]


def test_sim3_gate_matrix_healthy_poisoned_stopgo():
    """tests/test_vo_sequence.py's gate matrix: each decision and its
    three observables equal the reference's."""
    vo = MonoVO.__new__(MonoVO)
    vo.vo_cfg = VOConfig()
    ref = jodo.MonoVO.__new__(jodo.MonoVO)
    ref.vo_cfg = JVOConfig()
    rng = np.random.default_rng(7)
    n = 40
    frames = list(range(0, 4 * n, 4))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()

    def chain(speeds):
        c = np.zeros((n, 3), np.float32)
        c[1:, 0] = np.cumsum(speeds)
        return -c

    def decide(t_raw, t_corr):
        corr = (eye, t_corr, np.ones(n, np.float32))
        sigs = []
        for cls, obj in ((MonoVO, vo), (jodo.MonoVO, ref)):
            s = (cls._speed_dispersion(eye, t_raw, None, frames),
                 cls._speed_dispersion(*corr, frames),
                 cls._correction_roughness(eye, t_raw, corr, frames))
            sigs.append((obj._gate_accept(*s), s))
        assert sigs[0] == sigs[1]
        return sigs[0]

    seg = np.arange(n - 1)
    drift = np.exp(np.cumsum(rng.normal(0, 0.06, n - 1)))
    ok, sigs = decide(chain(np.ones(n - 1) * drift), chain(np.ones(n - 1)))
    assert ok, sigs
    v_raw = np.exp(rng.normal(0, 0.03, n - 1))
    v_bad = v_raw.copy()
    v_bad[n // 2:] *= 8.0
    ok, sigs = decide(chain(v_raw), chain(v_bad))
    assert not ok, sigs
    v_true = np.exp(0.7 * np.sin(2 * np.pi * seg / (n - 1)))
    drift = np.exp(-0.65 * np.sin(2 * np.pi * seg / (n - 1))
                   + np.cumsum(rng.normal(0, 0.01, n - 1)))
    ok, (sig_raw, sig_corr, sig_delta) = decide(chain(v_true * drift), chain(v_true))
    assert sig_corr > sig_raw * vo.vo_cfg.sim3_gate_margin and ok
    v_broken = np.ones(n - 1)
    v_broken[20:] = 6.0
    ok, (sig_raw, sig_corr, sig_delta) = decide(chain(v_broken), chain(np.ones(n - 1)))
    assert sig_delta > vo.vo_cfg.sim3_gate_smooth and ok


# ---- checkpoints ----

@pytest.fixture(scope="module")
def seq10():
    return two_plane_sequence(n_frames=10, h=240, w=320, seed=9, motion_scale=0.7,
                              amplitude=2.0)


VO_CKPT = dict(max_keyframes=16, kf_every=2, loop_temporal_gap=50)


def test_mono_checkpoint_resume_equivalence(tmp_path, seq10):
    def build():
        return _vo(seq10, SIFT_CKPT, vo_cfg=VOConfig(**VO_CKPT), ba_window=4)

    full = build()
    for img in seq10.images[:6]:
        full.process(img)
    ckpt = str(tmp_path / "vo.npz")
    full.checkpoint(ckpt)
    for img in seq10.images[6:]:
        full.process(img)
    er_a, et_a = full.trajectory()
    resumed = build()
    resumed.restore(ckpt)
    assert resumed.n_kf >= 2
    for img in seq10.images[6:]:
        resumed.process(img)
    er_b, et_b = resumed.trajectory()
    assert len(er_b) == len(er_a)
    np.testing.assert_allclose(et_b, et_a, atol=1e-5)
    np.testing.assert_allclose(er_b, er_a, atol=1e-5)




@pytest.mark.parametrize("shape", [(230, 310), (376, 1000), (2000, 100)])
def test_pad_to_tier_matches_jax(shape):
    from cusift_tpu.utils.image import pad_to_tier as jpad
    from cusift_tpu_torch.utils.image import pad_to_tier

    img = np.random.default_rng(1).random(shape, dtype=np.float32)
    (got, content), (ref, ref_content) = pad_to_tier(img), jpad(img)
    assert content == ref_content == shape
    np.testing.assert_array_equal(got, ref)


def test_mono_vo_pad_to_tier(seq6):
    """MonoVO(pad_to_tier=True) on 230x310 crops: frames padded to the
    480x640 tier, every valid feature inside the content, every pair
    tracked."""
    vo = _vo(seq6, SIFT_PAIR, ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3),
             pad_to_tier=True)
    feats = []
    vo.on_metric = lambda stat: feats.append(vo._feats)
    vo.run([im[:230, :310] for im in seq6.images[:3]])
    assert vo._content == (230, 310) and len(feats) == 2
    assert all(s["ok"] for s in vo.stats)
    border = vo.sift_cfg.border
    for f in feats:
        assert bool(f.valid.any())
        assert float(f.x[f.valid].max()) < 310 - border and float(f.y[f.valid].max()) < 230 - border

"""The port's map-anchored mono frontend (cusift_tpu_torch/models/monomap.py
and `MonoVO(vo_cfg=VOConfig(map_anchor=True))`) against the JAX package.

* Twins of tests/test_monomap.py's six tests at their scenes and bars, on
  the port alone: RANSAC streams differ between the packages, so the runs
  are held on outcomes (the three VO runs take 3-6 s each on the CPU, so
  none is marked slow).
* `insert_step` against JAX slot for slot on a partly full map whose
  `seen` epochs tie (both top-k's break ties to the lower index): masks,
  epochs, counts and descriptors exact, positions to 1e-6 (one 3x3
  product a row).
* `localize_step` against JAX on clean geometry, where every RANSAC stream
  finds the same inlier set, in the accept, rescue and fallback cases:
  masks and integers exact, floats to LOC_ATOL.
* The map in the checkpoint: the port's keys round-trip through the JAX
  `MonoVO(map_anchor=True)` (restore, then checkpoint again, no frame
  processed); the port's `pnp_rescue` route (the pair step's rescued
  output feeds `localize_step`, as the reference's selection does).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import MatchConfig as JMatchConfig
from cusift_tpu.config import RansacConfig as JRansacConfig
from cusift_tpu.config import SiftConfig as JSiftConfig
from cusift_tpu.config import VOConfig as JVOConfig
from cusift_tpu.models import monomap as jmm
from cusift_tpu.models.odometry import MonoVO as JMonoVO
from cusift_tpu_torch.config import MatchConfig, RansacConfig, SiftConfig, VOConfig
from cusift_tpu_torch.data.evaluation import ate_rmse
from cusift_tpu_torch.data.synthetic import two_plane_sequence
from cusift_tpu_torch.models import odometry as todo
from cusift_tpu_torch.models.monomap import LandmarkMap, empty_map, insert_step, localize_step
from cusift_tpu_torch.models.odometry import MonoVO
from monomap_scene import INTR, clean_scene, project, rot_y, unit_desc
from monomap_scene import tensor as _t

torch.set_num_threads(2)

SIFT = dict(max_kpts=384, max_kpts_per_octave=256, num_octaves=3, upscale=False)
# floats of localize_step against JAX on clean geometry: the rescue case's
# PnP pose differs by 2.8e-6 (float32 solves summed in another order), the
# landmark means by 4.8e-7; the accept and fallback poses are equal
LOC_ATOL = 1e-5


# ---- twins of tests/test_monomap.py's fast tests ----

def test_insert_then_localize_roundtrip():
    """Landmarks inserted at identity localise a moved camera exactly."""
    n, msize = 128, 512
    intr = _t(INTR)
    desc = _t(unit_desc(n, 0))
    rng = np.random.default_rng(1)
    x = _t(rng.uniform(40, 280, n), np.float32)
    y = _t(rng.uniform(30, 210, n), np.float32)
    depth = _t(rng.uniform(2.0, 6.0, n), np.float32)
    valid = torch.ones(n, dtype=torch.bool)

    lmap = empty_map(msize, "cpu")
    lmap = insert_step(lmap, desc, valid, torch.ones(n), x, y, intr, depth,
                       torch.zeros(n, dtype=torch.bool), torch.eye(3), torch.zeros(3), 0, 256)
    assert int(lmap.valid.sum()) == n

    r, t = rot_y(0.05), np.array([0.2, -0.1, 0.3], np.float32)
    u, v, _ = project(lmap.pos.numpy()[:n], r, t)
    # pair_ok=False: the pure-PnP rescue adopts the full PnP pose
    mt = localize_step(desc, valid, _t(u), _t(v), intr, torch.zeros(n), torch.zeros((n, 3)),
                       torch.tensor(False), torch.eye(3), torch.zeros(3), torch.tensor(0.3),
                       torch.tensor(0.3),
                       torch.eye(3), torch.zeros(3), torch.eye(3), torch.zeros(3),
                       lmap, 1, -5, 10, 2, 8, 0.4, MatchConfig(),
                       RansacConfig(num_hypotheses=256), torch.Generator().manual_seed(0))
    packed = mt.packed.numpy()
    assert packed[14] > 0.5, "PnP must accept"
    np.testing.assert_allclose(packed[:9].reshape(3, 3), r, atol=5e-3)
    np.testing.assert_allclose(packed[9:12], t, atol=1e-2)
    assert int((mt.lmap.seen == 1).sum()) >= 0.8 * n


def test_refinement_folds_duplicate_matches_once():
    """Duplicate best-matches to one landmark count as ONE observation:
    the fold segment-means them (nobs +1 a frame) and stays a running
    mean."""
    n, msize = 96, 512
    intr = _t(INTR)
    desc = unit_desc(n, 7)
    rng = np.random.default_rng(8)
    x = _t(rng.uniform(40, 280, n), np.float32)
    y = _t(rng.uniform(30, 210, n), np.float32)
    depth0 = _t(rng.uniform(2.0, 6.0, n), np.float32)
    lmap = insert_step(empty_map(msize, "cpu"), _t(desc), torch.ones(n, dtype=torch.bool),
                       torch.ones(n), x, y, intr, depth0, torch.zeros(n, dtype=torch.bool),
                       torch.eye(3), torch.zeros(3), 0, n)
    nobs0 = lmap.nobs.numpy().copy()

    r, t = rot_y(0.04), np.array([0.15, -0.05, 0.25], np.float32)
    pts_w = lmap.pos.numpy()[:n]
    u, v, z = project(pts_w, r, t)
    fx, fy, cx, cy = INTR
    qu = np.repeat(u, 2) + rng.uniform(-0.3, 0.3, 2 * n).astype(np.float32)
    qv = np.repeat(v, 2) + rng.uniform(-0.3, 0.3, 2 * n).astype(np.float32)
    q_depth = np.repeat(z, 2).astype(np.float32)
    q_xyn = np.stack([(qu - cx) / fx, (qv - cy) / fy], -1)
    q_pts = np.concatenate([q_xyn, np.ones_like(q_xyn[:, :1])], -1) * q_depth[:, None]

    mt = localize_step(_t(np.repeat(desc, 2, axis=0)), torch.ones(2 * n, dtype=torch.bool),
                       _t(qu, np.float32), _t(qv, np.float32), intr, _t(q_depth),
                       _t(q_pts, np.float32), torch.tensor(True), _t(r), _t(t),
                       torch.tensor(1.0), torch.tensor(1.0),
                       torch.eye(3), torch.zeros(3), torch.eye(3), torch.zeros(3),
                       lmap, 1, -5, 10, 5, 8, 0.4, MatchConfig(),
                       RansacConfig(num_hypotheses=256), torch.Generator().manual_seed(3))
    assert int(mt.inliers.sum()) >= n, "most duplicate observations should localise"
    d_nobs = mt.lmap.nobs.numpy() - nobs0
    assert d_nobs.max() == 1, f"max increment {d_nobs.max()}"
    assert (d_nobs >= 1).sum() >= 0.8 * n
    moved = np.linalg.norm(mt.lmap.pos.numpy()[:n] - pts_w, axis=-1)
    assert np.median(moved[d_nobs[:n] == 1]) < 0.05


def test_insert_eviction_prefers_invalid_then_oldest():
    msize, n = 64, 32
    intr = _t(INTR)
    lmap = empty_map(msize, "cpu")
    for epoch in range(3):
        lmap = insert_step(lmap, _t(unit_desc(n, epoch)), torch.ones(n, dtype=torch.bool),
                           torch.ones(n), torch.full((n,), 100.0), torch.full((n,), 100.0),
                           intr, torch.full((n,), 3.0), torch.zeros(n, dtype=torch.bool),
                           torch.eye(3), torch.zeros(3), epoch, n)
    seen = lmap.seen.numpy()[lmap.valid.numpy()]
    assert int(lmap.valid.sum()) == msize
    assert (seen >= 1).all()
    assert (seen == 2).sum() == n


# ---- against JAX ----

def _jmap(lm: LandmarkMap):
    return jmm.LandmarkMap(*(jnp.asarray(a.numpy()) for a in lm))


def _assert_map_equal(got: LandmarkMap, ref, pos_atol):
    for name in ("valid", "seen", "nobs", "desc"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos), atol=pos_atol, rtol=0)


def test_insert_step_matches_jax_slot_for_slot():
    """A partly full map (40 of 64 slots, epochs 0-2 tied 13-14 each) and
    48 candidates, some tied in response, some without depth, invalid or
    already inliers: the same slots receive the same rows."""
    rng = np.random.default_rng(4)
    m, n, budget = 64, 48, 32
    lm = empty_map(m, "cpu")
    live = np.sort(rng.choice(m, 40, replace=False))
    lm = LandmarkMap(
        pos=_t(np.where(np.isin(np.arange(m), live)[:, None], rng.normal(size=(m, 3)), 0.0),
               np.float32),
        desc=_t(unit_desc(m, 5)), valid=_t(np.isin(np.arange(m), live)),
        seen=_t(np.where(np.isin(np.arange(m), live), np.arange(m) % 3, -1), np.int32),
        nobs=_t(np.where(np.isin(np.arange(m), live), 1 + np.arange(m) % 4, 0), np.int32))
    resp = rng.choice([0.02, 0.03, 0.05], n).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, n).astype(np.float32)
    depth[::7] = 0.0
    valid = rng.uniform(size=n) > 0.1
    inl = rng.uniform(size=n) < 0.15
    x = rng.uniform(10, 310, n).astype(np.float32)
    y = rng.uniform(10, 230, n).astype(np.float32)
    r, t = rot_y(0.3), np.array([0.4, -0.2, 1.1], np.float32)
    desc = unit_desc(n, 6)
    got = insert_step(lm, _t(desc), _t(valid), _t(resp), _t(x), _t(y), _t(INTR), _t(depth),
                      _t(inl), _t(r), _t(t), 3, budget)
    ref = jmm.insert_step(_jmap(lm), jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(resp),
                          jnp.asarray(x), jnp.asarray(y), jnp.asarray(INTR),
                          jnp.asarray(depth), jnp.asarray(inl), jnp.asarray(r),
                          jnp.asarray(t), jnp.int32(3), budget)
    _assert_map_equal(got, ref, 1e-6)
    assert int(got.valid.sum()) == 40 + min(m - 40, int((valid & (depth > 1e-6) & ~inl).sum()))


CASES = {"accept": dict(pair_ok=True, min_inliers=20),
         "rescue": dict(pair_ok=False, min_inliers=20),
         "fallback": dict(pair_ok=True, min_inliers=100_000)}


@pytest.fixture(scope="module")
def scene():
    return clean_scene()


@pytest.mark.parametrize("case", sorted(CASES))
def test_localize_step_matches_jax(scene, case):
    s, c = scene, CASES[case]
    rcfg = dict(num_hypotheses=64)
    args = ("desc", "valid", "x", "y")
    got = localize_step(
        *(_t(s[a]) for a in args), _t(INTR), _t(s["depth"]), _t(s["pts"]),
        torch.tensor(c["pair_ok"]), _t(s["pair_r"]), _t(s["pair_t"]), torch.tensor(1.0),
        torch.tensor(1.0), _t(s["prev_r"]), _t(s["prev_t"]),
        _t(s["last_r"]), _t(s["last_t"]), s["lmap"], 5, 1, c["min_inliers"], 3, 8, 0.4,
        MatchConfig(), RansacConfig(**rcfg), torch.Generator().manual_seed(0))
    ref = jmm.localize_step(
        *(jnp.asarray(s[a]) for a in args), jnp.asarray(INTR), jnp.asarray(s["depth"]),
        jnp.asarray(s["pts"]), jnp.bool_(c["pair_ok"]), jnp.asarray(s["pair_r"]),
        jnp.asarray(s["pair_t"]), jnp.float32(1.0), jnp.float32(1.0), jnp.asarray(s["prev_r"]),
        jnp.asarray(s["prev_t"]), jnp.asarray(s["last_r"]), jnp.asarray(s["last_t"]),
        _jmap(s["lmap"]), jnp.int32(5), jnp.int32(1), jnp.int32(c["min_inliers"]),
        jnp.int32(3), jnp.int32(8), jnp.float32(0.4), JMatchConfig(),
        JRansacConfig(**rcfg), jax.random.PRNGKey(0))
    packed, rpacked = got.packed.numpy(), np.asarray(ref.packed)
    # r 9, t 3, scale, n_pnp, ok, s_med, n_anchor
    np.testing.assert_array_equal(packed[[13, 14, 16]], rpacked[[13, 14, 16]])
    np.testing.assert_allclose(packed, rpacked, atol=LOC_ATOL, rtol=0)
    assert packed[14] == (0.0 if case == "fallback" else 1.0)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    for name in ("pose_r", "pose_t", "rel_r", "rel_t", "scale", "depth", "pts"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=LOC_ATOL, rtol=0, err_msg=name)
    _assert_map_equal(got.lmap, ref.lmap, LOC_ATOL)
    grown = (got.lmap.nobs.numpy() > s["lmap"].nobs.numpy()).sum()
    # refinement needs depths (a failed pair has none) and folds the 60
    # immature active landmarks only, once each
    assert grown == (60 if case == "accept" else 0)
    assert int(got.inliers.sum()) == (0 if case == "fallback" else 176)


# ---- twins of tests/test_monomap.py's VO tests (slow there) ----

@pytest.fixture(scope="module")
def seq14():
    return two_plane_sequence(n_frames=14, h=240, w=320, seed=3, near=3.0, far=6.0,
                              motion_scale=0.6)


def _map_vo(seq, **kw):
    cfg = dict(max_keyframes=32, kf_every=2, map_anchor=True, map_size=2048, map_active_kf=8,
               map_insert_budget=256, map_min_inliers=15, map_min_obs=2, map_min_anchor=8,
               loop_temporal_gap=1000)
    cfg.update(kw)
    return MonoVO(seq.intr, sift_cfg=SiftConfig(**SIFT),
                  ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3), vo_cfg=VOConfig(**cfg),
                  device="cpu")


def test_map_anchor_survives_keyframe_ring_eviction(seq14):
    vo = _map_vo(seq14, max_keyframes=5)
    est_r, est_t = vo.run(list(seq14.images))
    assert len(est_r) == 14
    assert vo.n_kf == 5 and vo._kf_frame[-1] >= 10
    assert all(s["ok"] or s["pnp_ok"] for s in vo.stats)
    assert sum(s["pnp_ok"] for s in vo.stats[3:]) >= 0.5 * len(vo.stats[3:])
    assert np.isfinite(est_t).all()


def test_mono_vo_map_anchor_tracks_sequence(seq14):
    vo = _map_vo(seq14)
    est_r, est_t = vo.run(list(seq14.images))
    assert len(est_r) == 14
    pnp_frames = [s["pnp_ok"] for s in vo.stats]
    assert sum(pnp_frames[3:]) >= 0.7 * len(pnp_frames[3:])
    assert all(s["ok"] or s["pnp_ok"] for s in vo.stats)
    ate = ate_rmse(est_r, est_t, seq14.poses_r, seq14.poses_t, with_scale=True)
    path = np.linalg.norm(np.diff(-np.einsum("nij,ni->nj", seq14.poses_r, seq14.poses_t),
                                  axis=0), axis=-1).sum()
    assert ate < 0.16 * path


def test_map_anchor_checkpoint_resume_equivalence(tmp_path):
    seq = two_plane_sequence(n_frames=10, h=240, w=320, seed=3, near=3.0, far=6.0,
                             motion_scale=0.6)
    kw = dict(map_size=1024, map_insert_budget=128)
    full = _map_vo(seq, **kw)
    for img in seq.images[:6]:
        full.process(img)
    ckpt = str(tmp_path / "vo_map.npz")
    full.checkpoint(ckpt)
    for img in seq.images[6:]:
        full.process(img)
    resumed = _map_vo(seq, **kw)
    resumed.restore(ckpt)
    assert int(resumed._lmap.valid.sum()) > 0, "landmark table restored"
    for img in seq.images[6:]:
        resumed.process(img)
    for a, b in zip(resumed.trajectory(), full.trajectory()):
        np.testing.assert_allclose(a, b, atol=1e-5)


# ---- the checkpoint across packages, the rescue route ----

def test_map_checkpoint_keys_round_trip_through_jax(tmp_path, seq14):
    """The port's map-anchored checkpoint, restored by the JAX MonoVO and
    written again (no frame processed, so nothing compiles), restores in
    the port to the same landmark table, device pose state and inliers."""
    vo = _map_vo(seq14)
    for img in seq14.images[:5]:
        vo.process(img)
    assert int(vo._lmap.valid.sum()) > 0 and vo._map_inl is not None
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    vo.checkpoint(a)
    ref = JMonoVO(seq14.intr, sift_cfg=JSiftConfig(**SIFT),
                  ransac_cfg=JRansacConfig(inlier_thresh_epi=4e-3),
                  vo_cfg=JVOConfig(**{k: getattr(vo.vo_cfg, k) for k in
                                      ("max_keyframes", "kf_every", "map_anchor", "map_size",
                                       "map_active_kf", "map_insert_budget", "map_min_inliers",
                                       "map_min_obs", "map_min_anchor", "loop_temporal_gap")}))
    ref.restore(a)
    ref.checkpoint(b)
    back = _map_vo(seq14)
    back.restore(b)
    for name in LandmarkMap._fields:
        x, y = getattr(back._lmap, name), getattr(vo._lmap, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name
    for got, want in ((back._dev_pose, vo._dev_pose), (back._dev_rel, vo._dev_rel)):
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert torch.equal(back._map_inl, vo._map_inl)
    with np.load(a) as za, np.load(b) as zb:
        keys = [k for k in za.files if k.startswith(("lmap_", "dev_")) or k == "map_inl"]
        assert len(keys) == 10 and set(keys) <= set(zb.files)
        for k in keys:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("rescue", [True, False])
def test_map_anchor_takes_the_rescued_pair(monkeypatch, rescue):
    """`localize_step` consumes the pair step's selected output: with
    `pnp_rescue` on, a pair whose essential fit fails reaches the map as
    the PnP rescue's pose (pair_ok true), as the reference's on-device
    selection feeds it; off, as a failed pair.  The pair row is fetched
    before the map's (one fetch more a frame than the reference's, a
    route and not a result)."""
    seq = two_plane_sequence(n_frames=6, h=240, w=320, seed=7, motion_scale=0.8)
    fed, pairs = [], []
    real_loc, real_pair = todo.localize_step, todo.pair_step

    def loc(*a, **k):
        fed.append(a[7])
        return real_loc(*a, **k)

    def pair(*a, **k):
        out, row = real_pair(*a, **k)
        pairs.append((out.ok, row))
        return out, row

    monkeypatch.setattr(todo, "localize_step", loc)
    monkeypatch.setattr(todo, "pair_step", pair)
    vo = _map_vo(seq, pnp_rescue=rescue)
    vo.ransac_cfg = RansacConfig()
    for img in seq.images[:3]:
        vo.process(img)
    vo.ransac_cfg = replace(vo.ransac_cfg, inlier_thresh_epi=1e-9)
    for img in seq.images[3:]:
        vo.process(img)
    assert len(fed) == len(pairs) == 5
    for got, (ok, row) in zip(fed, pairs):
        assert got is ok and bool(ok) == (row[15] > 0.5)
    # the essential fits fail from frame 3 on; with the rescue on, PnP
    # supplies each of those pairs
    assert [bool(row[16] > 0.5) for _, row in pairs[2:]] == [rescue] * 3
    assert [bool(f) for f in fed[2:]] == [rescue] * 3
    assert [s["ok"] for s in vo.stats[2:]] == [rescue] * 3

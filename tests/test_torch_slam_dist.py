"""`Slam(dist_ba=True)` and `MonoVO(dist_ba=True)`: the window BA's Schur
solve split over the "map" axis of every rank (parallel/dist_ba.py).

* On a one-rank gloo group (what `dist_ba=True` makes when there is no
  group) the trajectory and keyframes are bit-equal to `dist_ba=False`:
  the one-rank all-reduces change nothing, and the split event form the
  distributed path takes equals the fused one.
* On 2 spawned gloo ranks, both ranks return bit-identical trajectories
  (the window's inputs are broadcast from the first rank; the reductions
  give every rank the same sums) with the keyframes and tracking of
  `dist_ba=False`.  With a window PCG that converges
  (`local_ba_cg_iters=50`) every frame lies within 1e-3 m of
  `dist_ba=False` (it reads 0 m).  With the default 15 PCG rounds the
  step is not converged and can amplify the two shards' partial-sum
  rounding (costs agree to 8-9 digits) into a step that differs by
  percents: one LM accept in the last window solve flipped on this scene
  before the tracking's RANSAC summed in a fixed order, and the last 3
  frames moved 0.0099, 0.0258 and 0.0417 m; the bounds stay at that
  reading (every frame now reads 0 m).  On the mono scene (12 PCG rounds, no flip) the first step
  that differs is the window's second LM step (|dc| 0.468 vs 0.458) and
  the frames after the two fixed ones move up to 0.0248; with 100 PCG
  rounds up to 0.0095.  The default-config bounds are those readings with
  a margin of about 1.5.
* The reference's own 2-device run (tools/ref_dist_ba_drift.py: its Slam
  with the window BA on 2 of the 8 virtual devices) does not move on its
  own scene.  On the port's six windows both packages' 2-way solves equal
  their single solves (0 m).  The last window is sensitive in either
  package: a 1e-7 relative change of the input translations moves the
  reference's solve 0.0042 m and the port's 0.0072.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import cusift_tpu_torch.models.slam as tslam
from cusift_tpu.config import BAConfig as JBAConfig
from cusift_tpu.config import MatchConfig as JMatchConfig
from cusift_tpu.models.local_ba import window_ba as jwindow_ba
from cusift_tpu.parallel.dist_ba import window_ba_dist as jwindow_ba_dist
from cusift_tpu.parallel.mesh import map_mesh as jmap_mesh

from cusift_tpu_torch import RansacConfig, SiftConfig, SlamConfig
from cusift_tpu_torch.data.evaluation import ate_rmse
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, two_plane_sequence
from cusift_tpu_torch.models.odometry import MonoVO
from cusift_tpu_torch.models.slam import Slam
from cusift_tpu_torch.parallel import launch
from cusift_tpu_torch.parallel.mesh import ensure_group

torch.set_num_threads(2)

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
RANSAC = RansacConfig(num_hypotheses=512, inlier_thresh_3d=0.03)
SLAM_CFG = SlamConfig(max_keyframes=16, loop_temporal_gap=50)
VO_SIFT = SiftConfig(max_kpts=512, max_kpts_per_octave=384, num_octaves=4)
VO_RANSAC = RansacConfig(inlier_thresh_epi=4e-3)


@pytest.fixture(scope="module")
def seq():
    return planar_rgbd_sequence(n_frames=10, h=240, w=320, seed=2, motion_scale=0.6)


@pytest.fixture(scope="module")
def mono():
    return two_plane_sequence(n_frames=6, h=240, w=320, seed=3, motion_scale=0.8)


def _slam(seq, **kw):
    slam = Slam(seq.intr, SIFT, ransac_cfg=RANSAC, slam_cfg=SLAM_CFG, device="cpu", **kw)
    recs = slam.run(zip(seq.images, seq.depths))
    return slam, recs


def _vo(mono, **kw):
    vo = MonoVO(mono.intr, VO_SIFT, ransac_cfg=VO_RANSAC, ba_window=4, ba_every=1,
                device="cpu", **kw)
    return vo, vo.run(list(mono.images))


@pytest.fixture(scope="module")
def single(seq):
    slam, recs = _slam(seq)
    return slam.trajectory(), slam.state.n_kf, [r.get("tracked", True) for r in recs]


@pytest.fixture(scope="module")
def single_vo(mono):
    vo, traj = _vo(mono)
    return traj, [s["ok"] for s in vo.stats], vo._last_ba


@pytest.fixture()
def one_rank_group():
    ensure_group("cpu", timeout_s=60)
    yield
    dist.destroy_process_group()


def test_slam_dist_one_rank_bit_equal(seq, single, one_rank_group):
    slam, _ = _slam(seq, dist_ba=True)
    assert slam._ba_mesh.shape == (1, 1) and not slam._fused_events
    (r0, t0), n_kf, _ = single
    r1, t1 = slam.trajectory()
    assert np.array_equal(r0, r1) and np.array_equal(t0, t1)
    assert slam.state.n_kf == n_kf >= 5          # the window BA ran


def test_vo_dist_one_rank_bit_equal(mono, single_vo, one_rank_group):
    vo, (r1, t1) = _vo(mono, dist_ba=True)
    (r0, t0), ok, last_ba = single_vo
    assert np.array_equal(r0, r1) and np.array_equal(t0, t1)
    assert vo._last_ba == last_ba


def test_slam_dist_two_ranks(seq, single):
    out = launch.run(launch.slam_task, 2,
                     args=(seq.intr, list(zip(seq.images, seq.depths)), SIFT, SLAM_CFG, RANSAC),
                     device="cpu", timeout_s=60)
    (r0, t0), n_kf, tracked = single
    a, b = out
    assert np.array_equal(a["t"], b["t"]) and np.array_equal(a["r"], b["r"])
    assert a["n_kf"] == b["n_kf"] == n_kf >= 5
    assert a["tracked"] == tracked and all(tracked)
    moved = np.linalg.norm(a["t"] - t0, axis=-1)
    assert moved[:7].max() < 1e-3, moved          # before the flipped LM accept
    assert moved.max() < 0.06, moved              # read: 0.0417 m
    ate_single = ate_rmse(r0, t0, seq.poses_r, seq.poses_t)
    ate_dist = ate_rmse(a["r"], a["t"], seq.poses_r, seq.poses_t)
    assert ate_single < 0.05 and ate_dist < 0.05, (ate_single, ate_dist)


def test_slam_dist_two_ranks_converged_cg(seq):
    """With a converged window PCG the shards' rounding no longer reaches
    the trajectory: every frame within 1e-3 m of `dist_ba=False`."""
    cfg = dataclasses.replace(SLAM_CFG, local_ba_cg_iters=50)
    slam = Slam(seq.intr, SIFT, ransac_cfg=RANSAC, slam_cfg=cfg, device="cpu")
    slam.run(zip(seq.images, seq.depths))
    r0, t0 = slam.trajectory()
    out = launch.run(launch.slam_task, 2,
                     args=(seq.intr, list(zip(seq.images, seq.depths)), SIFT, cfg, RANSAC),
                     device="cpu", timeout_s=60)
    for rank in out:
        assert rank["n_kf"] == slam.state.n_kf >= 5
        np.testing.assert_allclose(rank["t"], t0, atol=1e-3, rtol=0)
        np.testing.assert_allclose(rank["r"], r0, atol=1e-3, rtol=0)


def test_vo_dist_two_ranks(mono, single_vo):
    out = launch.run(launch.vo_task, 2,
                     args=(mono.intr, list(mono.images), VO_SIFT, VO_RANSAC, 4, 1, None),
                     device="cpu", timeout_s=60)
    (r0, t0), ok, _ = single_vo
    a, b = out
    assert np.array_equal(a["t"], b["t"]) and np.array_equal(a["r"], b["r"])
    assert a["ok"] == ok and all(ok)
    c0, c1 = a["last_ba"]
    assert c1 < c0 * 0.2                     # the sharded window fit converged
    moved = np.linalg.norm(a["t"] - t0, axis=-1)
    assert moved[:2].max() < 1e-3, moved          # the window's fixed poses
    assert moved.max() < 0.04, moved              # read: 0.0248
    path = np.linalg.norm(np.diff(-np.einsum("nij,ni->nj", mono.poses_r, mono.poses_t),
                                  axis=0), axis=-1).sum()
    ate_dist = ate_rmse(a["r"], a["t"], mono.poses_r, mono.poses_t, with_scale=True)
    ate_single = ate_rmse(r0, t0, mono.poses_r, mono.poses_t, with_scale=True)
    assert ate_dist <= max(2.5 * ate_single, 0.05 * path), (ate_dist, ate_single, path)


def test_last_window_sensitivity_shared_with_reference(seq):
    """Open check 3, where the packages part: every window BA of the
    port's run solved by each package on 2 ranks (devices) and on one.
    On this run both packages' 2-way solves equal their single solves in
    all six windows, and the last window is sensitive in either package:
    a 1e-7 relative change of its input translations moves either solve
    by millimetres.  So whether a 2-way solve parts from the single one
    is a matter of the inputs' last bits (before the tracking summed its
    RANSAC in a fixed order the port's sixth window parted, by 0.0383 m,
    and the reference's by 4.6e-4 m)."""
    windows = []
    plain = tslam.window_ba

    def captured(*args, **kw):
        windows.append([a.numpy().copy() for a in args[:7]])
        return plain(*args, **kw)

    tslam.window_ba = captured
    try:
        slam, _ = _slam(seq)
    finally:
        tslam.window_ba = plain
    assert len(windows) == 6
    cfg = slam._ba_cfg
    jcfg = JBAConfig(**dataclasses.asdict(cfg))

    def port(xs):
        return plain(*(torch.from_numpy(x) for x in xs), slam.match_cfg, cfg)[1].numpy()

    def ref(xs, mesh=None):
        xs = [jnp.asarray(x) for x in xs]
        if mesh is None:
            return np.asarray(jwindow_ba(*xs, JMatchConfig(), jcfg)[1])
        return np.asarray(jwindow_ba_dist(*xs, mesh, JMatchConfig(), jcfg)[1])

    out = launch.run(launch.ba_task, 2, args=({2: dict(windows=windows, window_cfg=cfg)},),
                     device="cpu", timeout_s=120)
    a, b = (rank[2]["windows"] for rank in out)
    assert all(torch.equal(x[1], y[1]) for x, y in zip(a, b))
    moved_port = [np.abs(x[1].numpy() - port(w)).max() for x, w in zip(a, windows)]
    moved_ref = [np.abs(ref(w, jmap_mesh(2)) - ref(w)).max() for w in windows]
    assert max(moved_port) < 1e-6 and max(moved_ref) < 1e-6, (moved_port, moved_ref)

    args = windows[-1]
    nudged = list(args)
    nudged[4] = args[4] * np.float32(1 + 1e-7)         # the translations
    moved_ref = np.abs(ref(nudged) - ref(args)).max()           # read: 0.0042
    moved_port = np.abs(port(nudged) - port(args)).max()        # read: 0.0072
    assert moved_ref > 1e-3 and moved_port > 1e-3, (moved_ref, moved_port)

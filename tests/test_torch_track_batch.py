"""The frame axis of the port's tracking programs (cusift_tpu_torch/ops/
match.py, kernels/matcher.py:top2_plain, ops/geometry.py:procrustes,
ops/ransac.py:find_rigid, ops/stereo.py:stereo_depth, models/slam.py:
_chunk_step, models/stereo.py:_stereo_chunk_step, models/local_ba.py:
build_window_problem), which replaces the reference's `jax.vmap`s.

* Batched `match` against the reference's `jax.vmap(match)` (its XLA path
  on the CPU) at B = 3, N = 256, M = 320, with a shared B side and with
  both sides batched: `idx` and `ok` equal, `dist` within rtol/atol 1e-5
  and `ratio` within rtol 1e-4, atol 1e-5 (the bounds of
  tests/test_pallas_matcher.py::test_matches_xla_path).
* The reference's `_pallas_top2` under `jax.vmap` in interpret mode
  against the port's batched `top2_plain` at B = 2, N = 64, M = 96: `idx`
  equal, scores within 1e-5.
* Batched `match`, `procrustes`, `find_rigid`, `stereo_depth`,
  `_chunk_step` and `_stereo_chunk_step` bit-equal to their per-frame
  calls (the same generators) at B = 1, 2, 3.
* Batched `find_rigid` against the reference's `jax.vmap(find_rigid)` on
  outcomes, at tests/test_torch_rigid.py's bounds (the PRNG streams
  differ): each frame's fit within 0.02 of the truth in R and t, >= 95%
  of its inliers kept, and the two packages' inlier sets agreeing on
  >= 95% of the points.
* The window BA association is one (batched) top-2 call; the order-fixed
  helpers (`mat3.tree_sum`, `mat3.matmul_small`) agree with torch's sum
  and matmul to float32 rounding (1e-6 relative) and do not move with the
  batch; K2's plan counts every frame's row blocks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import MatchConfig as JMatchConfig
from cusift_tpu.config import RansacConfig as JRansacConfig
from cusift_tpu.ops.match import match as jmatch
from cusift_tpu.ops.pallas.matcher import _pallas_top2
from cusift_tpu.ops.ransac import find_rigid as jfind_rigid
from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig, SlamConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, two_plane_stereo_sequence
from cusift_tpu_torch.kernels import matcher as k2
from cusift_tpu_torch.models import local_ba
from cusift_tpu_torch.models.slam import Slam, _chunk_step, _frame_step
from cusift_tpu_torch.models.stereo import StereoSlam, _stereo_chunk_step
from cusift_tpu_torch.ops import mat3
from cusift_tpu_torch.ops.geometry import procrustes
from cusift_tpu_torch.ops.match import match
from cusift_tpu_torch.ops.ransac import find_rigid
from cusift_tpu_torch.ops.stereo import stereo_depth

torch.set_num_threads(2)

T = torch.from_numpy
SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _match_inputs(rng, frames, n, m):
    """[frames, n] query and [frames, m] candidate unit descriptors: the
    queries and the first n candidates of every frame are noisy copies of
    one set in shuffled orders (so the ratio test passes many rows, a
    shared side included), the rest random; about a tenth of either side
    invalid."""
    base = rng.normal(size=(n, 128))
    a = np.stack([_unit(base[rng.permutation(n)] + 0.03 * rng.normal(size=(n, 128)))
                  for _ in range(frames)])
    b = _unit(rng.normal(size=(frames, m, 128)))
    for f in range(frames):
        b[f, :n] = _unit(base[rng.permutation(n)] + 0.03 * rng.normal(size=(n, 128)))
    return a, rng.random((frames, n)) > 0.1, b, rng.random((frames, m)) > 0.1


def _fields_equal(got, one, f):
    return all(torch.equal(x[f], y) for x, y in zip(got, one))


@pytest.mark.parametrize("shared", ["b", "none"])
def test_batched_match_matches_jax_vmap(shared):
    rng = np.random.default_rng(0)
    a, va, b, vb = _match_inputs(rng, 3, 256, 320)
    if shared == "b":
        b, vb = b[0], vb[0]
    cfg = MatchConfig(ratio_thresh=0.8)
    axes = (0, 0, None, None) if shared == "b" else (0, 0, 0, 0)
    ref = jax.vmap(functools.partial(jmatch, cfg=JMatchConfig(ratio_thresh=0.8, backend="xla")),
                   in_axes=axes)(*(jnp.asarray(x) for x in (a, va, b, vb)))
    got = match(T(a), T(va), T(b), T(vb), cfg)
    assert got.idx.shape == (3, 256)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.ratio.numpy(), np.asarray(ref.ratio), rtol=1e-4, atol=1e-5)
    assert got.ok.sum() > 300


def test_batched_top2_matches_vmapped_pallas_interpret():
    """The reference's K2 under vmap (a frame axis on its grid)."""
    rng = np.random.default_rng(1)
    a = _unit(rng.normal(size=(2, 64, 128)))
    b = _unit(rng.normal(size=(2, 96, 128)))
    b[1, 50] = b[1, 20]                        # a duplicated best: s1 == s2
    a[1, 3] = b[1, 20]
    vb = rng.random((2, 96)) > 0.1
    vb[1, 20] = vb[1, 50] = True
    top, idx = jax.vmap(functools.partial(_pallas_top2, interpret=True))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb))
    assert top.shape == (2, 64, 2)
    gtop, gidx = k2.top2_plain(T(a), T(b), T(vb))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(gtop.numpy(), np.asarray(top), atol=1e-5, rtol=0)
    assert gidx[1, 3] == 20 and gtop[1, 3, 0] == gtop[1, 3, 1]


@pytest.mark.parametrize("frames", [1, 2, 3])
@pytest.mark.parametrize("shared", ["b", "a", "none"])
def test_batched_match_bit_equal_to_frames(frames, shared):
    """Every field of frame f equals the call on frame f alone, with the
    cross-check's reverse pass batched too."""
    rng = np.random.default_rng(2)
    a, va, b, vb = (T(x) for x in _match_inputs(rng, frames, 200, 260))
    if shared == "b":
        b, vb = b[0], vb[0]
    elif shared == "a":
        a, va = a[0], va[0]
    for cfg in (MatchConfig(), MatchConfig(ratio_thresh=0.95, cross_check=True)):
        got = match(a, va, b, vb, cfg)
        assert got.idx.shape == (frames, 200)
        for f in range(frames):
            one = match(a if shared == "a" else a[f], va if shared == "a" else va[f],
                        b if shared == "b" else b[f], vb if shared == "b" else vb[f], cfg)
            assert _fields_equal(got, one, f), (cfg, f)


def _rigid_frames(rng, frames, n=300, n_out=80):
    """Point sets of `frames` rigid motions with noise and outliers, and
    the true motions."""
    from cusift_tpu_torch.data.synthetic import se3_exp

    pa = rng.uniform(-2, 2, size=(frames, n, 3)).astype(np.float32)
    pb = np.empty_like(pa)
    truth = []
    for f in range(frames):
        r, t = se3_exp(rng.normal(scale=0.2, size=6))
        pb[f] = pa[f] @ r.T + t + rng.normal(scale=0.005, size=(n, 3))
        pb[f, :n_out] += rng.uniform(0.5, 2.0, size=(n_out, 3))
        truth.append((r, t))
    valid = rng.random((frames, n)) > 0.05
    return pa, pb.astype(np.float32), valid, truth


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_batched_procrustes_and_find_rigid_bit_equal_to_frames(frames):
    rng = np.random.default_rng(3)
    pa, pb, valid, _ = (T(x) if isinstance(x, np.ndarray) else x
                        for x in _rigid_frames(rng, frames))
    w = (T(rng.random((frames, pa.shape[1]))) > 0.3).float()
    r, t = procrustes(pa, pb, w)
    for f in range(frames):
        for one in (procrustes(pa[f], pb[f], w[f]), procrustes(pa[f:f + 1], pb[f:f + 1],
                                                                  w[f:f + 1])):
            assert torch.equal(r[f], one[0].reshape(3, 3)) and torch.equal(t[f], one[1].reshape(3))
    cfg = RansacConfig(num_hypotheses=256)
    gens = [torch.Generator().manual_seed(100 + f) for f in range(frames)]
    got = find_rigid(pa, pb, valid, cfg, gens)
    assert got.r.shape == (frames, 3, 3) and got.num_inliers.shape == (frames,)
    for f in range(frames):
        one = find_rigid(pa[f], pb[f], valid[f], cfg, torch.Generator().manual_seed(100 + f))
        assert _fields_equal(got, one, f), f


def test_batched_find_rigid_matches_jax_vmap_outcomes():
    rng = np.random.default_rng(4)
    frames, n_out = 3, 80
    pa, pb, valid, truth = _rigid_frames(rng, frames, n_out=n_out)
    valid[:] = True
    cfg = RansacConfig(num_hypotheses=512)
    got = find_rigid(T(pa), T(pb), T(valid), cfg,
                     [torch.Generator().manual_seed(f) for f in range(frames)])
    keys = jax.random.split(jax.random.PRNGKey(0), frames)
    ref = jax.vmap(functools.partial(jfind_rigid, cfg=JRansacConfig(num_hypotheses=512)))(
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid), key=keys)
    for f, (r_true, t_true) in enumerate(truth):
        for r, t, inl, ok in ((got.r[f].numpy(), got.t[f].numpy(), got.inliers[f].numpy(),
                               bool(got.ok[f])),
                              (np.asarray(ref.r[f]), np.asarray(ref.t[f]),
                               np.asarray(ref.inliers[f]), bool(ref.ok[f]))):
            assert ok
            assert np.abs(r - r_true).max() < 0.02 and np.linalg.norm(t - t_true) < 0.02
            assert inl[n_out:].mean() > 0.95
        assert (got.inliers[f].numpy() == np.asarray(ref.inliers[f])).mean() >= 0.95


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_batched_stereo_depth_bit_equal_to_frames(frames):
    rng = np.random.default_rng(5)
    a, va, b, vb = _match_inputs(rng, frames, 200, 260)
    xl = rng.uniform(0, 320, (frames, 200)).astype(np.float32)
    yl = rng.uniform(0, 240, (frames, 200)).astype(np.float32)
    xr = rng.uniform(0, 320, (frames, 260)).astype(np.float32)
    yr = rng.uniform(0, 240, (frames, 260)).astype(np.float32)
    # the noisy copies sit on the same row at a positive disparity
    for f in range(frames):
        idx = match(T(a[f]), T(va[f]), T(b[f]), T(vb[f])).idx.numpy()
        xr[f, idx] = xl[f] - rng.uniform(1, 40, 200).astype(np.float32)
        yr[f, idx] = yl[f] + rng.uniform(-1, 1, 200).astype(np.float32)
    args = [T(x) for x in (a, va, xl, yl, b, vb, xr, yr)]
    fx, base = torch.tensor(300.0), torch.tensor(0.12)
    depth, ok = stereo_depth(*args, fx, base)
    assert ok.sum() > 100 * frames
    for f in range(frames):
        d1, ok1 = stereo_depth(*(x[f] for x in args), fx, base)
        assert torch.equal(depth[f], d1) and torch.equal(ok[f], ok1)


@pytest.fixture(scope="module")
def rgbd():
    return planar_rgbd_sequence(5, 240, 320, motion_scale=0.5, seed=4)


@pytest.fixture(scope="module")
def stereo():
    return two_plane_stereo_sequence(n_frames=5, h=240, w=320, seed=4, motion_scale=0.7,
                                     amplitude=2.0, baseline=0.12)


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_chunk_step_bit_equal_to_frame_steps(rgbd, frames):
    slam = Slam(rgbd.intr, sift_cfg=SIFT, slam_cfg=SlamConfig(max_keyframes=8), device="cpu")
    slam.process_frame(rgbd.images[0], rgbd.depths[0])
    _, kd, kv, kp = slam._ref_cache
    chunk = T(np.stack([np.stack([rgbd.images[i], rgbd.depths[i]])
                        for i in range(1, frames + 1)]))
    calls = []
    top2 = k2.top2

    def counted(*args):
        calls.append(args[0].shape)
        return top2(*args)

    k2.top2 = counted
    try:
        _, pts, rows = _chunk_step(chunk, slam.intr, kd, kv, kp, SIFT, slam.match_cfg,
                                   slam.ransac_cfg, slam._next_keys(frames))
    finally:
        k2.top2 = top2
    assert calls == [(frames, SIFT.total_kpts, 128)]      # one batched match
    slam._key_ctr -= frames
    for i in range(frames):
        _, p, row = _frame_step(chunk[i, 0], chunk[i, 1], slam.intr, kd, kv, kp, SIFT,
                                slam.match_cfg, slam.ransac_cfg, slam._next_key())
        assert torch.equal(row, rows[i]) and torch.equal(p, pts[i]), i
    assert bool((rows[:, 1] == 1).all())


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_stereo_chunk_step_bit_equal_to_frame_steps(stereo, frames):
    sift = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
    slam = StereoSlam(stereo.intr, stereo.baseline, sift_cfg=sift,
                      slam_cfg=SlamConfig(max_keyframes=8), device="cpu")
    slam.process_frame(stereo.images_l[0], stereo.images_r[0])
    _, kd, kv, kp = slam._ref_cache
    chunk = T(np.stack([np.stack([stereo.images_l[i], stereo.images_r[i]])
                        for i in range(1, frames + 1)]))
    _, pts, rows = _stereo_chunk_step(chunk, slam.intr, slam.baseline, kd, kv, kp, sift,
                                      slam.match_cfg, slam.ransac_cfg, slam._next_keys(frames))
    slam._key_ctr -= frames
    for i in range(frames):
        _, p, row = slam._sense_step(chunk[i, 0], chunk[i, 1], kd, kv, kp, slam._next_key())
        assert torch.equal(row, rows[i]) and torch.equal(p, pts[i]), i
    assert bool((rows[:, 1] == 1).all())


def test_window_association_is_one_batched_call(rgbd):
    from cusift_tpu_torch.models.slam import _extract_with_points

    intr = T(rgbd.intr)
    out = [_extract_with_points(T(rgbd.images[i]), T(rgbd.depths[i]), intr, SIFT)
           for i in range(5)]
    kd = torch.stack([f.desc for f, _, _ in out])
    kv = torch.stack([f.valid for f, _, _ in out])
    kp = torch.stack([p for _, p, _ in out])
    calls = []
    top2 = k2.top2

    def counted(*args):
        calls.append((tuple(args[0].shape), tuple(args[1].shape)))
        return top2(*args)

    k2.top2 = counted
    try:
        prob = local_ba.build_window_problem(kd, kv, kp, T(rgbd.poses_r), T(rgbd.poses_t),
                                             intr, torch.ones(5))
    finally:
        k2.top2 = top2
    n = SIFT.total_kpts
    assert calls == [((n, 128), (5, n, 128))]
    assert prob.uv.shape == (5 * n, 2) and int((prob.w > 0).sum()) > 100


@pytest.mark.parametrize("n", [1, 3, 5, 1000, 2048])
def test_order_fixed_helpers(n):
    rng = np.random.default_rng(6)
    x = T(rng.normal(size=(4, n, 9)).astype(np.float32))
    s = mat3.tree_sum(x, -2)
    torch.testing.assert_close(s, x.double().sum(-2).float(), rtol=1e-6, atol=1e-5 * n ** 0.5)
    for f in range(4):
        assert torch.equal(s[f], mat3.tree_sum(x[f], -2))
    a = T(rng.normal(size=(n, 4, 4)).astype(np.float32))
    b = T(rng.normal(size=(n, 4, 3)).astype(np.float32))
    p = mat3.matmul_small(a, b)
    torch.testing.assert_close(p, a @ b, rtol=1e-6, atol=1e-6)
    assert torch.equal(p[-1], mat3.matmul_small(a[-1], b[-1]))


def test_top2_plan_counts_every_frame():
    one = k2._launch_plan(2048, 2048, 128, 132)
    eight = k2._launch_plan(2048, 2048, 128, 132, frames=8)
    assert one["blocks"] == one["row_blocks"] * one["splits"]
    assert eight["blocks"] == eight["row_blocks"] * eight["splits"] * 8
    assert eight["splits"] <= one["splits"]          # the frames fill the card first
    assert eight["scratch_rows"] == (eight["splits"] * 8 * 2048 if eight["splits"] > 1 else 0)
    forced = k2._launch_plan(700, 1500, 128, 132, frames=8, splits=4)
    assert forced["splits"] == 4 and (4 - 1) * forced["cols_per_split"] < 1500

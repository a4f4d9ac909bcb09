"""The port's RGB-D rigid alignment (cusift_tpu_torch/ops/geometry.py,
ops/mat3.py:inv3_spd, ops/ransac.py:find_rigid, models/twoview.py:
align_rgbd_pair) against the JAX package.

* `procrustes` recovers an exact rigid motion to 1e-5 with det 1 (the
  bound of tests/test_ransac.py::test_procrustes_exact), and on the same
  numpy sample indices (JAX: one-hot weights over all points; the port:
  the gathered 3 points with unit weights, as its RANSAC solves them) the
  two agree to 5e-5 (1e-5 for a weighted fit over all points).
* `masked_median`, `backproject`, `project` and `inv3_spd` agree to
  float32 rounding (1e-6 relative; `inv3_spd` 1e-5 relative on blocks of
  condition up to 1e8).
* RANSAC draws from a torch generator, not jax's threefry stream, so
  `find_rigid` and `align_rgbd_pair` are held on their outcomes at the
  reference tests' bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cusift_tpu.ops import geometry as jgeo
from cusift_tpu.ops import mat3 as jmat3
from cusift_tpu.ops.ransac import _onehot_weights
from cusift_tpu.optim.lie import so3_exp
from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
from cusift_tpu_torch.models.twoview import align_rgbd_pair
from cusift_tpu_torch.ops import geometry as tgeo
from cusift_tpu_torch.ops import mat3 as tmat3
from cusift_tpu_torch.ops.ransac import find_rigid

torch.set_num_threads(2)

T = torch.from_numpy


def test_procrustes_exact():
    rng = np.random.default_rng(0)
    r_true = np.asarray(so3_exp(jnp.asarray([-0.4, 0.2, 0.1])))
    t_true = np.array([1.0, 2.0, -0.5])
    pa = rng.normal(size=(20, 3)).astype(np.float32)
    pb = (pa @ r_true.T + t_true).astype(np.float32)
    r, t = tgeo.procrustes(T(pa), T(pb), torch.ones(20))
    np.testing.assert_allclose(r.numpy(), r_true, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), t_true, atol=1e-5)
    assert abs(np.linalg.det(r.numpy().astype(np.float64)) - 1.0) < 1e-5


def test_procrustes_on_the_same_sample_indices_as_jax():
    rng = np.random.default_rng(1)
    r_true = np.asarray(so3_exp(jnp.asarray([0.3, -0.2, 0.25])))
    pa = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    pb = (pa @ r_true.T + [0.3, -0.2, 0.5] + rng.normal(scale=0.01, size=pa.shape)
          ).astype(np.float32)
    idx = rng.integers(0, 50, (40, 3))
    idx = idx[[len(set(i)) == 3 for i in idx]]
    w = jax.vmap(lambda i: _onehot_weights(i, 50))(jnp.asarray(idx))
    rj, tj = jax.vmap(lambda wi: jgeo.procrustes(jnp.asarray(pa), jnp.asarray(pb), wi))(w)
    rt, tt = tgeo.procrustes(T(pa[idx]), T(pb[idx]), torch.ones(idx.shape))
    # a 3-point cross-covariance summed over 3 terms here and over 50
    # (47 of them zero) there differs in its last bits, which the power
    # iteration scales by 1 / (eigengap): 5e-5 on minimal samples
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=5e-5, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-5, rtol=0)
    # and the weighted all-points form the IRLS refinement uses
    wall = (rng.random(50) > 0.3).astype(np.float32)
    for got, ref in zip(tgeo.procrustes(T(pa), T(pb), T(wall)),
                        jgeo.procrustes(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(wall))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_projection_helpers_match_jax():
    rng = np.random.default_rng(2)
    uv = rng.uniform(0, 320, (64, 2)).astype(np.float32)
    d = rng.uniform(0.5, 4.0, 64).astype(np.float32)
    d[::7] = 0.0
    intr = (517.3, 516.5, 318.6, 255.3)
    pts = tgeo.backproject(T(uv), T(d), *intr)
    ref = jgeo.backproject(jnp.asarray(uv), jnp.asarray(d), *intr)
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    pts_np = np.asarray(ref).copy()
    pts_np[3, 2] = 0.0                                       # the depth clamp
    np.testing.assert_allclose(tgeo.project(T(pts_np), *intr).numpy(),
                               np.asarray(jgeo.project(jnp.asarray(pts_np), *intr)),
                               rtol=1e-6)
    vals = rng.normal(size=33).astype(np.float32)
    for mask in (rng.random(33) > 0.4, np.zeros(33, bool), np.ones(33, bool)):
        got = float(tgeo.masked_median(T(vals), T(mask)))
        assert got == float(jgeo.masked_median(jnp.asarray(vals), jnp.asarray(mask)))


def test_inv3_spd_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(64, 3, 3))
    m = a @ a.transpose(0, 2, 1)
    # thin-ray blocks: one direction nearly unobserved (condition ~1e8)
    u = rng.normal(size=(16, 3))
    m[:16] = 1e4 * u[:, :, None] * u[:, None, :] + 1e-4 * np.eye(3)
    m = m.astype(np.float32)
    ref = np.asarray(jmat3.inv3_spd(jnp.asarray(m)))
    got = tmat3.inv3_spd(T(m)).numpy()
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5, rtol=0)


def test_rigid_recovery():
    """tests/test_ransac.py::test_rigid_recovery's bounds."""
    rng = np.random.default_rng(0)
    r_true = np.asarray(so3_exp(jnp.asarray([0.2, -0.1, 0.3])))
    t_true = np.array([0.3, -0.2, 0.5])
    n, n_out = 150, 40
    pa = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    pb = pa @ r_true.T + t_true + rng.normal(scale=0.005, size=(n, 3))
    pb[:n_out] += rng.uniform(0.5, 2.0, size=(n_out, 3))
    res = find_rigid(T(pa), T(pb.astype(np.float32)), torch.ones(n, dtype=torch.bool),
                     RansacConfig(num_hypotheses=512))
    assert bool(res.ok)
    assert np.linalg.norm(res.t.numpy() - t_true) < 0.02
    assert np.abs(res.r.numpy() - r_true).max() < 0.02
    assert res.inliers[n_out:].float().mean() > 0.95
    again = find_rigid(T(pa), T(pb.astype(np.float32)), torch.ones(n, dtype=torch.bool),
                       RansacConfig(num_hypotheses=512),
                       torch.Generator().manual_seed(0))
    assert torch.equal(res.r, again.r)              # seeded from cfg.seed


def test_rigid_degenerate_input_no_nan():
    z = torch.zeros(32, 3)
    res = find_rigid(z, z, torch.zeros(32, dtype=torch.bool), RansacConfig(num_hypotheses=64))
    assert not bool(res.ok)
    assert bool(torch.isfinite(res.r).all()) and bool(torch.isfinite(res.t).all())


def test_rgbd_pair_alignment():
    """tests/test_slam.py::test_rgbd_pair_alignment: frames 0 and 2, R within
    0.01 and t within 0.01 m of ground truth."""
    seq = planar_rgbd_sequence(n_frames=8, h=240, w=320, seed=2, motion_scale=0.6)
    sift = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
    res = align_rgbd_pair(seq.images[0], seq.depths[0], seq.images[2], seq.depths[2],
                          seq.intr, sift, MatchConfig(),
                          RansacConfig(num_hypotheses=512, inlier_thresh_3d=0.03),
                          device="cpu")
    assert bool(res.rigid.ok)
    r_true = seq.poses_r[2] @ seq.poses_r[0].T
    t_true = seq.poses_t[2] - r_true @ seq.poses_t[0]
    assert np.abs(res.rigid.r.numpy() - r_true).max() < 0.01
    assert np.linalg.norm(res.rigid.t.numpy() - t_true) < 0.01

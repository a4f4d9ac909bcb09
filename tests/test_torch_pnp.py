"""The port's DLT-PnP RANSAC (cusift_tpu_torch/ops/pnp.py) against the JAX
package's, and at the bars of tests/test_pnp.py.

Parity on the same numpy points: `solve_pnp` (weighted, non-minimal) and
`reprojection_error2` to 1e-5 relative; `find_pnp` with the sample indices
drawn in numpy and fed to both packages (each package's sampler patched),
with and without a prior pose, to 1e-4.  Then test_pnp.py's outcome bars
on the port's own stream: exact recovery, outliers, metric scale, all
invalid input and noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cusift_tpu.ops.pnp as jpnp
from cusift_tpu.config import RansacConfig as JRansacConfig
from cusift_tpu_torch.config import RansacConfig
from cusift_tpu_torch.ops import pnp as tpnp
from cusift_tpu_torch.ops.pnp import find_pnp, reprojection_error2, solve_pnp

torch.set_num_threads(2)


def _rot(axis, ang):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)).astype(np.float32)


def _scene(n, seed=0, depth_lo=2.0, depth_hi=8.0):
    """tests/test_pnp.py's scene: world points + a pose (pts_w, xyn, r, t)."""
    rng = np.random.default_rng(seed)
    r = _rot(rng.normal(size=3), 0.4)
    t = np.array([0.3, -0.2, 0.5], np.float32)
    xy = rng.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32)
    z = rng.uniform(depth_lo, depth_hi, size=(n, 1)).astype(np.float32)
    pts_w = (np.concatenate([xy * z, z], -1) - t) @ r
    return pts_w.astype(np.float32), xy, r, t


def _outliers(xyn, n, seed=3):
    rng = np.random.default_rng(seed)
    bad = rng.random(n) < 0.35
    xyn = xyn.copy()
    xyn[bad] += rng.uniform(0.05, 0.3, size=(bad.sum(), 2)) * rng.choice([-1, 1], size=(bad.sum(), 2))
    return xyn, bad


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_solve_and_error_match_jax():
    pts, xyn, r, t = _scene(40, seed=1)
    xyn = xyn + np.random.default_rng(1).normal(scale=1e-3, size=xyn.shape).astype(np.float32)
    w = np.random.default_rng(2).uniform(0.5, 1.5, 40).astype(np.float32)
    got = solve_pnp(*_t(pts, xyn, w))
    ref = jpnp.solve_pnp(jnp.asarray(pts), jnp.asarray(xyn), jnp.asarray(w))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    got = reprojection_error2(*_t(r, t, pts, xyn))
    ref = jpnp.reprojection_error2(*(jnp.asarray(a) for a in (r, t, pts, xyn)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("with_init", [False, True])
def test_find_pnp_same_samples_as_jax(monkeypatch, with_init):
    n = 256
    pts, xyn, r, t = _scene(n, seed=2)
    xyn, _ = _outliers(xyn, n)
    valid = np.ones(n, bool)
    valid[::9] = False
    cfg = dict(num_hypotheses=64, seed=4321 + with_init)
    idx = np.random.default_rng(9).choice(np.nonzero(valid)[0], size=(63, 12)).astype(np.int32)
    monkeypatch.setattr(jpnp, "_sample_indices", lambda *a: jnp.asarray(idx))
    monkeypatch.setattr(tpnp, "_sample_indices", lambda *a: torch.from_numpy(idx).long())
    init = (_rot([0.2, 1.0, 0.1], 0.38), t + 0.02) if with_init else None
    ref = jpnp.find_pnp(jnp.asarray(pts), jnp.asarray(xyn), jnp.asarray(valid),
                        JRansacConfig(**cfg), None,
                        None if init is None else tuple(jnp.asarray(a) for a in init))
    res = find_pnp(*_t(pts, xyn, valid), RansacConfig(**cfg), None,
                   None if init is None else tuple(_t(*init)))
    assert bool(res.ok) == bool(ref.ok)
    assert abs(int(res.num_inliers) - int(ref.num_inliers)) <= 1
    np.testing.assert_allclose(res.r.numpy(), np.asarray(ref.r), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), atol=1e-4)


# ---- tests/test_pnp.py's outcome bars on the port ----

def test_solve_pnp_exact_recovery():
    pts, xyn, r, t = _scene(32, seed=1)
    re, te = solve_pnp(*_t(pts, xyn, np.ones(32, np.float32)))
    np.testing.assert_allclose(re.numpy(), r, atol=2e-3)
    np.testing.assert_allclose(te.numpy(), t, atol=5e-3)


def test_find_pnp_with_outliers():
    n = 256
    pts, xyn, r, t = _scene(n, seed=2)
    xyn, bad = _outliers(xyn, n)
    res = find_pnp(*_t(pts, xyn, np.ones(n, bool)), RansacConfig(num_hypotheses=256))
    assert bool(res.ok)
    assert int(res.num_inliers) >= 0.9 * (~bad).sum()
    assert not np.any(res.inliers.numpy() & bad)
    np.testing.assert_allclose(res.r.numpy(), r, atol=5e-3)
    np.testing.assert_allclose(res.t.numpy(), t, atol=1e-2)


@pytest.mark.parametrize("s", [0.1, 10.0])
def test_find_pnp_scale_is_metric(s):
    pts, xyn, r, t = _scene(64, seed=4)
    res = find_pnp(*_t(pts * s, xyn, np.ones(64, bool)), RansacConfig(num_hypotheses=128))
    assert bool(res.ok)
    np.testing.assert_allclose(res.t.numpy(), t * s, rtol=2e-2, atol=1e-2 * s)


def test_find_pnp_all_invalid():
    pts, xyn, _, _ = _scene(64, seed=5)
    res = find_pnp(*_t(pts, xyn, np.zeros(64, bool)))
    assert not bool(res.ok)
    assert torch.isfinite(res.r).all()


def test_find_pnp_noise_tolerance():
    n = 200
    pts, xyn, r, t = _scene(n, seed=6)
    xyn = xyn + np.random.default_rng(7).normal(scale=1e-3, size=xyn.shape).astype(np.float32)
    res = find_pnp(*_t(pts, xyn, np.ones(n, bool)), RansacConfig(num_hypotheses=256))
    assert bool(res.ok)
    np.testing.assert_allclose(res.r.numpy(), r, atol=2e-2)
    np.testing.assert_allclose(res.t.numpy(), t, atol=5e-2)

"""The port's essential-matrix geometry (cusift_tpu_torch/ops/essential.py)
against the JAX package's, and at the bars of tests/test_essential.py.

Parity on the same numpy points: `sampson_error` and
`decompose_essential` to 1e-5 relative.  `solve_essential` and
`triangulate_midpoint` are ill-conditioned float32 solves, so there the
bar is accuracy against float64 (the port's formula on float64 inputs):
the reference scene's near-parallel rays put both packages' midpoint
depths 2e-3 from float64 and 7e-4 from each other, so the port must be
within 1e-4 relative of the reference and no farther from float64 than
1.5x the reference's distance; on a noisy 256-point solve the unit-norm E
of the port sits 8.5e-5 from float64 where the reference's sits 3.7e-6
(XLA contracts the unrolled Cholesky's multiply-subtracts into FMAs,
eager torch rounds twice), so E is held within 2e-4 of both.
`find_essential` with the sample indices drawn in numpy and fed
to both packages (each package's sampler patched for the call) picks the
same winner and agrees to 1e-4 (float32 IRLS over 5 rounds).  Then the
outcome bars of tests/test_essential.py on the port's own stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cusift_tpu.ops.essential as jess
from cusift_tpu.config import RansacConfig as JRansacConfig
from cusift_tpu.optim.lie import se3_exp
from cusift_tpu_torch.config import RansacConfig
from cusift_tpu_torch.ops import essential as tess
from cusift_tpu_torch.ops.essential import (decompose_essential, find_essential,
                                            sampson_error, solve_essential,
                                            triangulate_midpoint)

torch.set_num_threads(2)


def _scene(seed=0, n=256, outliers=0, noise=0.0):
    """tests/test_essential.py's scene: random 3D points, xb = R xa + t."""
    rs = np.random.default_rng(seed)
    pts = rs.uniform([-2.0, -1.5, 4.0], [2.0, 1.5, 10.0], size=(n, 3))
    xi = np.array([0.3, 0.05, 0.1, 0.02, 0.06, 0.01])
    r, t = (np.asarray(a) for a in se3_exp(jnp.asarray(xi)))
    xa = pts[:, :2] / pts[:, 2:]
    pb = pts @ r.T + t
    xb = pb[:, :2] / pb[:, 2:]
    if noise:
        xa = xa + rs.normal(scale=noise, size=xa.shape)
        xb = xb + rs.normal(scale=noise, size=xb.shape)
    if outliers:
        bad = rs.choice(n, outliers, replace=False)
        xb[bad] = rs.uniform(-0.5, 0.5, size=(outliers, 2))
    return (xa.astype(np.float32), xb.astype(np.float32),
            r.astype(np.float32), t.astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _unit(v):
    return v / np.linalg.norm(v)


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _as_accurate(got, ref, f64, scale=1.0):
    """got within 1e-4 relative of ref, and no farther from the float64
    evaluation than 1.5x ref's distance (plus an f32 ulp of `scale`)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    assert np.abs(got - f64).max() <= 1.5 * np.abs(ref - f64).max() + 1e-7 * scale


def test_solve_and_sampson_match_jax():
    xa, xb, _, _ = _scene(seed=1, noise=1e-4)
    w = np.random.default_rng(2).uniform(0.5, 1.5, len(xa)).astype(np.float32)
    e = solve_essential(*_t(xa, xb, w)).numpy()
    e_ref = np.asarray(jess.solve_essential(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(w)))
    e64 = solve_essential(*(x.double() for x in _t(xa, xb, w))).numpy()
    e, e64 = (a * np.sign(np.sum(a * e_ref)) for a in (e, e64))   # E up to sign
    assert np.abs(e - e64).max() < 2e-4 and np.abs(e - e_ref).max() < 2e-4
    _close(sampson_error(*_t(e_ref, xa, xb)),
           jess.sampson_error(jnp.asarray(e_ref), jnp.asarray(xa), jnp.asarray(xb)),
           atol=1e-10)   # cancellation at 1e-11; the inlier gate is 4e-6


def test_triangulate_and_decompose_match_jax():
    xa, xb, r, t = _scene(seed=3)
    got = triangulate_midpoint(*_t(r, t, xa, xb))
    ref = jess.triangulate_midpoint(*(jnp.asarray(a) for a in (r, t, xa, xb)))
    f64 = triangulate_midpoint(*(x.double() for x in _t(r, t, xa, xb)))
    for a, b, c in zip(got, ref, f64):
        _as_accurate(a, b, c.numpy(), scale=10.0)
    w = np.ones(len(xa), np.float32)
    e = np.asarray(jess.solve_essential(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(w)))
    rr, tt, n_good = decompose_essential(*_t(e, xa, xb, w))
    rr_ref, tt_ref, n_ref = jess.decompose_essential(*(jnp.asarray(a) for a in (e, xa, xb, w)))
    _close(rr, rr_ref, atol=1e-5)
    _close(tt, tt_ref, atol=1e-5)
    assert int(n_good) == int(n_ref)


def test_find_essential_same_samples_as_jax(monkeypatch):
    """Both packages fed the same numpy-drawn samples: same E, R, t,
    inliers and verdict."""
    xa, xb, _, _ = _scene(seed=4, n=512, outliers=150, noise=5e-4)
    valid = np.ones(len(xa), bool)
    valid[::7] = False
    cfg = dict(num_hypotheses=64, seed=4321)
    idx = np.random.default_rng(9).choice(np.nonzero(valid)[0], size=(64, 8)).astype(np.int32)
    monkeypatch.setattr(jess, "_sample_indices", lambda *a: jnp.asarray(idx))
    monkeypatch.setattr(tess, "_sample_indices", lambda *a: torch.from_numpy(idx).long())
    ref = jess.find_essential(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(valid),
                              JRansacConfig(**cfg))
    res = find_essential(*_t(xa, xb, valid), RansacConfig(**cfg))
    assert bool(res.ok) == bool(ref.ok)
    assert int(res.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(ref.inliers))
    e, e_ref = res.e.numpy(), np.asarray(ref.e)
    _close(e * np.sign(np.sum(e * e_ref)), e_ref, atol=1e-4)
    _close(res.r, ref.r, atol=1e-4)
    _close(res.t, ref.t, atol=1e-4)


# ---- tests/test_essential.py's outcome bars on the port ----

def test_solve_essential_exact():
    xa, xb, r, t = _scene(seed=1)
    e = solve_essential(*_t(xa, xb, np.ones(len(xa), np.float32)))
    err = sampson_error(e, *_t(xa, xb)).numpy()
    assert np.sqrt(err.mean()) < 1e-4
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    assert abs(np.dot(_unit(e.numpy().ravel()), _unit((tx @ r).ravel()))) > 0.999


def test_decompose_recovers_motion():
    xa, xb, r, t = _scene(seed=2)
    w = np.ones(len(xa), np.float32)
    e = solve_essential(*_t(xa, xb, w))
    rr, tt, n_good = decompose_essential(e, *_t(xa, xb, w))
    assert int(n_good) > 250
    np.testing.assert_allclose(rr.numpy(), r, atol=1e-3)
    assert np.dot(_unit(tt.numpy()), _unit(t)) > 0.999


def test_triangulate_midpoint_depths():
    xa, xb, r, t = _scene(seed=3)
    pts, za, zb = triangulate_midpoint(*_t(r, t, xa, xb))
    gt = np.random.default_rng(3).uniform([-2.0, -1.5, 4.0], [2.0, 1.5, 10.0], size=(len(xa), 3))
    np.testing.assert_allclose(pts.numpy(), gt, atol=1e-2)
    assert (za.numpy() > 0).all() and (zb.numpy() > 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_find_essential_with_outliers_and_noise(seed):
    xa, xb, r, t = _scene(seed=4, n=512, outliers=150, noise=5e-4)
    gen = torch.Generator().manual_seed(seed)
    res = find_essential(*_t(xa, xb, np.ones(len(xa), bool)), RansacConfig(), gen)
    assert bool(res.ok)
    assert int(res.num_inliers) > 300
    np.testing.assert_allclose(res.r.numpy(), r, atol=1e-2)
    assert np.dot(_unit(res.t.numpy()), _unit(t)) > 0.99


def test_find_essential_degenerate_few_matches():
    xa, xb, _, _ = _scene(seed=5, n=16)
    valid = np.zeros(16, bool)
    valid[:5] = True
    res = find_essential(*_t(xa, xb, valid), RansacConfig())
    assert not bool(res.ok)
    assert all(torch.isfinite(x).all() for x in (res.e, res.r, res.t))

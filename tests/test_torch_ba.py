"""The port's bundle adjustment (cusift_tpu_torch/optim/ba.py) against the
JAX package's, and at the bounds of tests/test_ba.py.

Parity on `ba_problem(seed=3, n_cams=6, n_pts=60)`, the same numpy arrays
in both packages:
* residuals to 1e-4 px and the analytic Jacobian blocks J_c, J_p to 1e-6
  relative to their largest entry (the reference takes `jax.jacfwd` at
  zero twist);
* one `build_blocks` step's U, V^-1, W and b blocks at rtol 1e-4 of each
  block's largest entry, and one `solve_normal_equations` step of each
  solver ("cg", "dense") to 2e-4 of the largest camera step (float32 PCG
  and eigen solves in another summation order);
* the grid layout's segment sums (reshape + sum) equal `index_add_`'s to
  float32 rounding;
* the LM loop's final cost to rtol 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import BAConfig as JBAConfig
from cusift_tpu.data.synthetic import ba_problem
from cusift_tpu.optim import ba as jba
from cusift_tpu_torch.config import BAConfig
from cusift_tpu_torch.optim import ba as tba

torch.set_num_threads(2)


def _jax_problem(d):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})


def _problem(d, grid=True):
    return tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()},
                         grid=grid)


@pytest.fixture(scope="module")
def problem():
    prob, truth = ba_problem(seed=3, n_cams=6, n_pts=60, pixel_noise=0.25)
    return prob, truth


def _rel(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref,
                               atol=tol * max(np.abs(ref).max(), 1e-30), rtol=0)


def test_jacobians_match_jacfwd(problem):
    prob, _ = problem
    res, jc, jp = tba._residuals_and_jacobians(_problem(prob))
    rres, rjc, rjp = jba._residuals_and_jacobians(_jax_problem(prob))
    np.testing.assert_allclose(res.numpy(), np.asarray(rres), atol=1e-4, rtol=0)
    _rel(jc.numpy(), rjc, 1e-6)
    _rel(jp.numpy(), rjp, 1e-6)


def test_build_blocks_matches_jax(problem):
    prob, _ = problem
    for huber in (0.0, 1.0):
        got = tba.build_blocks(_problem(prob), torch.tensor(1e-3), huber)
        ref = jba.build_blocks(_jax_problem(prob), jnp.float32(1e-3), huber)
        for name in ("u", "v_inv", "wo", "b_c", "b_p"):
            _rel(getattr(got, name).numpy(), getattr(ref, name), 1e-4)


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_one_step_matches_jax(problem, solver):
    prob, _ = problem
    cfg = dict(max_iters=15, cg_iters=60, num_fixed_poses=2, solver=solver)
    rdc, rdp = jba.solve_normal_equations(_jax_problem(prob), jnp.float32(1e-3),
                                          JBAConfig(**cfg))
    for grid in (True, False):
        dc, dp = tba.solve_normal_equations(_problem(prob, grid), torch.tensor(1e-3),
                                            BAConfig(**cfg))
        _rel(dc.numpy(), rdc, 2e-4)
        _rel(dp.numpy(), rdp, 2e-4)


def test_grid_sums_equal_index_add(problem):
    prob, _ = problem
    a = tba.build_blocks(_problem(prob, True), torch.tensor(1e-3), 0.0)
    b = tba.build_blocks(_problem(prob, False), torch.tensor(1e-3), 0.0)
    for x, y in zip(a, b):
        _rel(x.numpy(), y.numpy(), 1e-6)


def test_lm_cost_matches_jax(problem):
    prob, _ = problem
    cfg = dict(max_iters=15, cg_iters=40)
    res = tba.bundle_adjust(_problem(prob), BAConfig(**cfg))
    ref = jba.bundle_adjust(_jax_problem(prob), JBAConfig(**cfg))
    np.testing.assert_allclose(float(res.initial_cost), float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-4)


# ---- the outcome tests of tests/test_ba.py, at its bounds ----

def test_cost_decreases(problem):
    res = tba.bundle_adjust(_problem(problem[0]), BAConfig(max_iters=15, cg_iters=40))
    assert float(res.cost) < 0.05 * float(res.initial_cost)
    assert int(res.iterations) >= 3


def test_recovers_poses(problem):
    prob, truth = problem
    res = tba.bundle_adjust(_problem(prob), BAConfig(max_iters=20, cg_iters=40,
                                                     num_fixed_poses=2))
    r_err = np.abs(res.poses_r.numpy() - truth["poses_r"]).max()
    t_err = np.linalg.norm(res.poses_t.numpy() - truth["poses_t"], axis=-1).max()
    assert r_err < 0.01, f"rotation error {r_err}"
    assert t_err < 0.02, f"translation error {t_err}"


def test_reprojection_rmse(problem):
    p = _problem(problem[0])
    res = tba.bundle_adjust(p, BAConfig(max_iters=20, cg_iters=40))
    p2 = p._replace(poses_r=res.poses_r, poses_t=res.poses_t, points=res.points)
    rmse = float(torch.sqrt(2.0 * tba.cost(p2) / p.w.sum()))
    assert rmse < 0.6, f"reprojection rmse {rmse:.3f}px"


def test_zero_weight_obs_ignored(problem):
    p = _problem(problem[0])
    uv_bad = p.uv.clone()
    uv_bad[::2] += 500.0
    w2 = p.w.clone()
    w2[::2] = 0.0
    ra = tba.bundle_adjust(p._replace(uv=uv_bad, w=w2), BAConfig(max_iters=5, cg_iters=30))
    rb = tba.bundle_adjust(p._replace(w=w2), BAConfig(max_iters=5, cg_iters=30))
    np.testing.assert_allclose(ra.poses_t.numpy(), rb.poses_t.numpy(), atol=1e-5)


def test_huber_resists_outliers():
    prob, truth = ba_problem(seed=5, n_cams=5, n_pts=50, pixel_noise=0.25)
    rs = np.random.default_rng(0)
    n_o = len(prob["uv"])
    bad = rs.choice(n_o, n_o // 10, replace=False)
    prob["uv"][bad] += rs.uniform(30, 80, size=(len(bad), 2))
    res = tba.bundle_adjust(_problem(prob), BAConfig(max_iters=25, cg_iters=40,
                                                     huber_delta=2.0, num_fixed_poses=2))
    t_err = np.linalg.norm(res.poses_t.numpy() - truth["poses_t"], axis=-1).max()
    assert t_err < 0.05, f"translation error with outliers {t_err}"


def test_dense_solver_matches_cg(problem):
    p = _problem(problem[0])
    cfg = BAConfig(max_iters=15, cg_iters=60, num_fixed_poses=2)
    r_cg = tba.bundle_adjust(p, cfg)
    r_d = tba.bundle_adjust(p, dataclasses.replace(cfg, solver="dense"))
    assert float(r_d.cost) <= float(r_d.initial_cost)
    np.testing.assert_allclose(float(r_d.cost), float(r_cg.cost), rtol=2e-3)
    np.testing.assert_allclose(r_d.poses_t.numpy(), r_cg.poses_t.numpy(), atol=5e-3)

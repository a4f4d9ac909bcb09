"""The port's pose graph (cusift_tpu_torch/optim/posegraph.py) against the
JAX package's, and at the bounds of tests/test_posegraph.py.

Parity on `pose_ring(n=20, drift=0.02, seed=1)`, the same numpy arrays in
both packages: the per-edge [6, 12] Jacobians (one batched forward-mode
pass with dual tensors against `jax.jacfwd`) to 1e-5, and both solvers' final cost to rtol 1e-3 and poses
to 1e-4 (float32 LM over 15 iterations, the matrix-free products summed in
another order than the reference's jvp/vjp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import PoseGraphConfig as JPGConfig
from cusift_tpu.data.synthetic import pose_ring
from cusift_tpu.optim import posegraph as jpg
from cusift_tpu_torch.config import PoseGraphConfig
from cusift_tpu_torch.optim import posegraph as tpg
from cusift_tpu_torch.optim.posegraph import PoseGraph, cost, optimize

torch.set_num_threads(2)

_KEYS = ("init_r", "init_t", "edge_i", "edge_j", "meas_r", "meas_t", "weight")


def _graph(d):
    return PoseGraph(*(torch.from_numpy(np.array(d[k])) for k in _KEYS))


def _jax_graph(d):
    return jpg.PoseGraph(*(jnp.asarray(d[k]) for k in _KEYS))


@pytest.fixture(scope="module")
def ring():
    return pose_ring(n=20, drift=0.02, seed=1)


def test_edge_jacobians_match_jacfwd(ring):
    g = _jax_graph(ring)
    ei, ej = g.edge_i, g.edge_j
    args = (jnp.zeros(12), g.poses_r[ei], g.poses_t[ei], g.poses_r[ej], g.poses_t[ej],
            g.meas_r, g.meas_t, g.weight)
    axes = (None, 0, 0, 0, 0, 0, 0, 0)
    ref_res = jax.vmap(jpg._edge_residual_12, in_axes=axes)(*args)
    ref_jac = jax.vmap(jax.jacfwd(jpg._edge_residual_12), in_axes=axes)(*args)
    res, jac = tpg.edge_jacobians(_graph(ring))
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res), atol=1e-6, rtol=0)
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref_jac), atol=1e-5, rtol=0)


@pytest.mark.parametrize("solver", ["cg", "dense"])
@pytest.mark.parametrize("huber", [0.0, 1.0])
def test_solvers_match_jax(ring, solver, huber):
    kw = dict(max_iters=15, solver=solver, huber_delta=huber)
    res = optimize(_graph(ring), PoseGraphConfig(**kw))
    ref = jpg.optimize(_jax_graph(ring), JPGConfig(**kw))
    np.testing.assert_allclose(float(res.initial_cost), float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(res.poses_t.numpy(), np.asarray(ref.poses_t), atol=1e-4)
    np.testing.assert_allclose(res.poses_r.numpy(), np.asarray(ref.poses_r), atol=1e-4)


def test_unknown_solver_raises(ring):
    with pytest.raises(ValueError, match="solver"):
        optimize(_graph(ring), PoseGraphConfig(solver="qr"))


# ---- the outcome tests of tests/test_posegraph.py, at its bounds ----

def test_cost_decreases(ring):
    res = optimize(_graph(ring), PoseGraphConfig(max_iters=15))
    assert float(res.cost) < 0.1 * float(res.initial_cost)


def _centre_err(r, t, ring):
    c = -np.einsum("nij,nj->ni", np.swapaxes(np.asarray(r), 1, 2), np.asarray(t))
    cg = -np.einsum("nij,nj->ni", np.swapaxes(ring["gt_r"], 1, 2), ring["gt_t"])
    return np.linalg.norm(c - cg, axis=-1)


def test_drift_reduced(ring):
    res = optimize(_graph(ring), PoseGraphConfig(max_iters=20))
    before = _centre_err(ring["init_r"], ring["init_t"], ring)
    after = _centre_err(res.poses_r, res.poses_t, ring)
    assert after.max() < 0.5 * before.max()
    assert after.mean() < 0.1


def _with_edge(g, i, j, mr, mt, w):
    return g._replace(
        edge_i=torch.cat([g.edge_i, torch.tensor([i], dtype=g.edge_i.dtype)]),
        edge_j=torch.cat([g.edge_j, torch.tensor([j], dtype=g.edge_j.dtype)]),
        meas_r=torch.cat([g.meas_r, torch.as_tensor(mr, dtype=torch.float32)[None]]),
        meas_t=torch.cat([g.meas_t, torch.as_tensor(mt, dtype=torch.float32)[None]]),
        weight=torch.cat([g.weight, torch.tensor([w], dtype=torch.float32)]))


def test_zero_weight_edges_ignored(ring):
    g = _graph(ring)
    gi = _with_edge(g, 0, 10, np.eye(3), [9.0, 9.0, 9.0], 0.0)
    ra = optimize(g, PoseGraphConfig(max_iters=8))
    rb = optimize(gi, PoseGraphConfig(max_iters=8))
    np.testing.assert_allclose(ra.poses_t.numpy(), rb.poses_t.numpy(), atol=1e-5)


def test_perfect_graph_zero_cost(ring):
    gt_r, gt_t = ring["gt_r"], ring["gt_t"]
    i, j = ring["edge_i"], ring["edge_j"]
    rrel = np.einsum("eab,ecb->eac", gt_r[i], gt_r[j])
    trel = gt_t[i] - np.einsum("eab,eb->ea", rrel, gt_t[j])
    g = _graph(ring)._replace(poses_r=torch.from_numpy(gt_r), poses_t=torch.from_numpy(gt_t),
                              meas_r=torch.from_numpy(rrel.astype(np.float32)),
                              meas_t=torch.from_numpy(trel.astype(np.float32)))
    assert float(cost(g)) < 1e-8


def test_dense_solver_matches_cg(ring):
    g = _graph(ring)
    rcg = optimize(g, PoseGraphConfig(max_iters=15))
    rde = optimize(g, PoseGraphConfig(max_iters=15, solver="dense"))
    assert float(rde.cost) < 0.1 * float(rde.initial_cost)
    np.testing.assert_allclose(float(rde.cost), float(rcg.cost), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(rde.poses_t.numpy(), rcg.poses_t.numpy(), rtol=1e-2, atol=1e-3)


def test_dense_solver_padded_graph(ring):
    """The SLAM loop's padded shape: dead ring slots and weight-0 padding
    edges keep dx = 0 there and do not sink the Cholesky."""
    n = ring["init_r"].shape[0]
    kfcap, ecap = n + 12, 64
    e = len(ring["edge_i"])
    pr = np.broadcast_to(np.eye(3, dtype=np.float32), (kfcap, 3, 3)).copy()
    pt = np.zeros((kfcap, 3), np.float32)
    pr[:n], pt[:n] = ring["init_r"], ring["init_t"]
    ei = np.zeros(ecap, np.int32)
    ej = np.zeros(ecap, np.int32)
    mr = np.broadcast_to(np.eye(3, dtype=np.float32), (ecap, 3, 3)).copy()
    mt = np.zeros((ecap, 3), np.float32)
    w = np.zeros(ecap, np.float32)
    ei[:e], ej[:e] = ring["edge_i"], ring["edge_j"]
    mr[:e], mt[:e], w[:e] = ring["meas_r"], ring["meas_t"], 1.0
    gp = PoseGraph(*(torch.from_numpy(a) for a in (pr, pt, ei, ej, mr, mt, w)))
    ref = optimize(_graph(ring), PoseGraphConfig(max_iters=10, solver="dense"))
    res = optimize(gp, PoseGraphConfig(max_iters=10, solver="dense"))
    assert not bool(torch.isnan(res.poses_t).any())
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(res.poses_t[n:].numpy(), 0.0, atol=1e-6)


def test_dense_solver_robust_kernel(ring):
    res = optimize(_graph(ring), PoseGraphConfig(max_iters=15, solver="dense",
                                                 huber_delta=1.0))
    assert float(res.cost) < 0.5 * float(res.initial_cost)


def test_robust_kernel_bounds_outlier_edge(ring):
    g = _graph(ring)
    bad_t = np.random.default_rng(5).normal(size=3) * 2.0
    gi = _with_edge(g, 2, 12, np.eye(3), bad_t, 2.0)

    def err(res):
        return _centre_err(res.poses_r, res.poses_t, ring).max()

    e_clean = err(optimize(g, PoseGraphConfig(max_iters=20)))
    e_l2 = err(optimize(gi, PoseGraphConfig(max_iters=20)))
    e_tuk = err(optimize(gi, PoseGraphConfig(max_iters=20, huber_delta=1.0,
                                             robust_kernel="tukey")))
    assert e_l2 > 2.0 * e_clean, (e_l2, e_clean)
    assert e_tuk < 2.0 * e_clean, (e_tuk, e_clean)


def test_non_pd_step_is_rejected_not_raised(ring):
    """A system whose Cholesky fails gives a NaN step, which the LM accept
    rejects (the reference's factorisation also yields NaN); nothing
    raises and the poses stay finite."""
    g = _graph(ring)
    g = g._replace(weight=torch.full_like(g.weight, float("inf")))
    res = optimize(g, PoseGraphConfig(max_iters=3, solver="dense"))
    np.testing.assert_array_equal(res.poses_t.numpy(), ring["init_t"])

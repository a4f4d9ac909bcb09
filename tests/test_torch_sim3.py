"""The port's Sim(3) pose graph (cusift_tpu_torch/optim/sim3graph.py)
against the JAX package's, and at the bars of tests/test_sim3.py.

Parity on the same numpy arrays: the algebra (`sim3_compose`,
`sim3_inverse`) and the residuals and cost to 1e-5; the per-edge [7, 14]
Jacobian blocks (one forward-mode pass with dual tensors) against the
matching blocks of `jax.jacfwd` of the reference's `_residuals` to 1e-5;
and on test_sim3.py's scale-drift, SE(3)-failure and robust-outlier
problems the final cost within 1e-3 relative of JAX's (float32 LM, the
CG products summed in another order than the reference's jvp/vjp), with
that file's own bars on the port's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import PoseGraphConfig as JPGConfig
from cusift_tpu.optim import sim3graph as jsim
from cusift_tpu.optim.lie import se3_exp
from cusift_tpu_torch.config import PoseGraphConfig
from cusift_tpu_torch.optim import sim3graph as tsim
from cusift_tpu_torch.optim.sim3graph import Sim3Graph, optimize, sim3_compose, sim3_inverse

torch.set_num_threads(2)


def _rot(rng, scale=0.3):
    return np.asarray(se3_exp(jnp.asarray(rng.normal(size=6) * scale))[0], np.float32)


def test_sim3_algebra_matches_jax(rng):
    s = rng.uniform(0.5, 2.0, size=(2, 5)).astype(np.float32)
    r = np.stack([[_rot(rng) for _ in range(5)] for _ in range(2)])
    t = rng.normal(size=(2, 5, 3)).astype(np.float32)
    ours = sim3_compose(*(torch.from_numpy(a[0]) for a in (s, r, t)),
                        *(torch.from_numpy(a[1]) for a in (s, r, t)))
    ref = jsim.sim3_compose(*(jnp.asarray(a[0]) for a in (s, r, t)),
                            *(jnp.asarray(a[1]) for a in (s, r, t)))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    inv = sim3_inverse(*ours)
    ident = sim3_compose(*inv, *ours)
    np.testing.assert_allclose(ident[0].numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(ident[1].numpy(), np.broadcast_to(np.eye(3), (5, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(ident[2].numpy(), 0.0, atol=1e-5)
    for a, b in zip(inv, jsim.sim3_inverse(*ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def _drift_problem(n=16, gamma=0.03):
    """tests/test_sim3.py's closed loop with scale-drifted odometry: node
    k's step translation scaled by e^(gamma k), one loop edge (0, n-1)
    measuring the relative epoch scale."""
    gt_r, gt_t = [np.eye(3)], [np.zeros(3)]
    for k in range(1, n):
        s = k / (n - 1)
        xi = np.array([0.6 * np.sin(2 * np.pi * s), 0.1 * np.sin(4 * np.pi * s),
                       0.5 * np.sin(2 * np.pi * s + 1.1), 0.05 * np.sin(2 * np.pi * s),
                       0.30 * np.sin(2 * np.pi * s), 0.05 * np.sin(4 * np.pi * s)])
        r, t = (np.asarray(a) for a in se3_exp(jnp.asarray(xi)))
        gt_r.append(r)
        gt_t.append(t)
    gt_r, gt_t = np.stack(gt_r), np.stack(gt_t)
    ei, ej, mr, mt, ms = [], [], [], [], []
    est_r, est_t = [gt_r[0]], [gt_t[0]]
    for k in range(n - 1):
        r_rel = gt_r[k] @ gt_r[k + 1].T
        t_rel = gt_t[k] - r_rel @ gt_t[k + 1]
        drift = np.exp(gamma * k)
        ei.append(k)
        ej.append(k + 1)
        mr.append(r_rel)
        mt.append(t_rel * drift)
        ms.append(1.0)
        est_r.append(r_rel.T @ est_r[-1])
        est_t.append(r_rel.T @ (est_t[-1] - t_rel * drift))
    r_rel = gt_r[0] @ gt_r[n - 1].T
    ei.append(0)
    ej.append(n - 1)
    mr.append(r_rel)
    mt.append(gt_t[0] - r_rel @ gt_t[n - 1])
    ms.append(np.exp(-gamma * (n - 2)))
    f32 = np.float32
    return (gt_r, gt_t, dict(
        poses_r=np.stack(est_r).astype(f32), poses_t=np.stack(est_t).astype(f32),
        poses_s=np.ones(n, f32), edge_i=np.array(ei, np.int32), edge_j=np.array(ej, np.int32),
        meas_r=np.stack(mr).astype(f32), meas_t=np.stack(mt).astype(f32),
        meas_s=np.array(ms, f32), weight=np.ones(len(ei), f32)))


def _with_outlier(arrays):
    """test_sim3.py's false revisit: one weight-2 garbage edge (0, n/2)."""
    a = dict(arrays)
    n = len(a["poses_s"])
    rng = np.random.default_rng(3)
    bad_r, _ = (np.asarray(x) for x in se3_exp(jnp.asarray(rng.normal(size=6) * 0.5)))
    a["edge_i"] = np.append(a["edge_i"], 0).astype(np.int32)
    a["edge_j"] = np.append(a["edge_j"], n // 2).astype(np.int32)
    a["meas_r"] = np.concatenate([a["meas_r"], bad_r[None]]).astype(np.float32)
    a["meas_t"] = np.concatenate([a["meas_t"], rng.normal(size=(1, 3)) * 0.8]).astype(np.float32)
    a["meas_s"] = np.append(a["meas_s"], 1.0).astype(np.float32)
    a["weight"] = np.append(a["weight"], 2.0).astype(np.float32)
    return a


def _graph(a):
    return Sim3Graph(**{k: torch.from_numpy(np.array(v)) for k, v in a.items()})


def _jgraph(a):
    return jsim.Sim3Graph(**{k: jnp.asarray(v) for k, v in a.items()})


def _centres(r, t):
    return np.einsum("nij,nj->ni", np.transpose(r, (0, 2, 1)), -t)


@pytest.fixture(scope="module")
def drift():
    return _drift_problem()


def test_residuals_and_cost_match_jax(drift):
    _, _, a = drift
    xi = np.random.default_rng(5).normal(scale=0.05, size=(16, 7)).astype(np.float32)
    res = tsim._residuals(torch.from_numpy(xi), _graph(a))
    ref = jsim._residuals(jnp.asarray(xi), _jgraph(a))
    np.testing.assert_allclose(res.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tsim.cost(_graph(a))), float(jsim.cost(_jgraph(a))),
                               rtol=1e-5)


@pytest.mark.parametrize("outlier", [False, True])
def test_edge_jacobians_match_jacfwd(drift, outlier):
    _, _, a = drift
    a = _with_outlier(a) if outlier else a
    g = _jgraph(a)
    n = len(a["poses_s"])
    full = np.asarray(jax.jacfwd(lambda xi: jsim._residuals(xi, g))(jnp.zeros((n, 7))))
    e = np.arange(len(a["edge_i"]))
    ref = np.concatenate([full[e, :, a["edge_i"]], full[e, :, a["edge_j"]]], -1)
    res, jac = tsim.edge_jacobians(_graph(a))
    np.testing.assert_allclose(res.numpy(), np.asarray(jsim._residuals(jnp.zeros((n, 7)), g)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(jac.numpy(), ref, atol=1e-5, rtol=0)


CFG = dict(max_iters=30, cg_iters=60)


def _solve_both(a, **kw):
    res = optimize(_graph(a), PoseGraphConfig(**CFG, **kw))
    ref = jsim.optimize(_jgraph(a), JPGConfig(**CFG, **kw))
    np.testing.assert_allclose(float(res.initial_cost), float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-3)
    return res


def _corrected_err(res, gt_r, gt_t):
    s = res.poses_s.numpy()
    ct = res.poses_t.numpy() / s[:, None]
    return np.linalg.norm(_centres(res.poses_r.numpy(), ct) - _centres(gt_r, gt_t), axis=1)


def test_sim3_recovers_scale_drift(drift):
    gt_r, gt_t, a = drift
    err0 = np.linalg.norm(_centres(a["poses_r"], a["poses_t"]) - _centres(gt_r, gt_t), axis=1)
    assert err0.max() > 0.15
    res = _solve_both(a)
    assert float(res.cost) < 0.05 * float(res.initial_cost)
    err1 = _corrected_err(res, gt_r, gt_t)
    assert err1.max() < 0.25 * err0.max(), (err1.max(), err0.max())
    ratio = res.poses_s.numpy() / np.exp(0.03 * np.arange(16))
    assert np.std(np.log(ratio[1:])) < 0.15


def test_se3_graph_cannot_absorb_scale_drift(drift):
    """The same data through the port's SE(3) graph keeps a large floor."""
    from cusift_tpu_torch.optim.posegraph import PoseGraph, optimize as se3_opt

    _, _, a = drift
    g = PoseGraph(*(torch.from_numpy(a[k]) for k in
                    ("poses_r", "poses_t", "edge_i", "edge_j", "meas_r", "meas_t", "weight")))
    res = se3_opt(g, PoseGraphConfig(**CFG))
    assert float(res.cost) > 1e-2 * float(res.initial_cost)


@pytest.mark.parametrize("delta,kernel", [(0.0, "huber"), (0.15, "huber"), (1.0, "tukey")])
def test_robust_kernel_rejects_outlier_loop_edge(drift, delta, kernel):
    gt_r, gt_t, a = drift
    a = _with_outlier(a)
    err_init = np.linalg.norm(_centres(a["poses_r"], a["poses_t"]) - _centres(gt_r, gt_t),
                              axis=1).max()
    res = _solve_both(a, huber_delta=delta, robust_kernel=kernel)
    err = _corrected_err(res, gt_r, gt_t).max()
    if delta == 0.0:
        assert err > 2.0 * err_init, "the outlier must demonstrably hijack L2"
    elif kernel == "huber":
        err_l2 = _corrected_err(optimize(_graph(a), PoseGraphConfig(**CFG)), gt_r, gt_t).max()
        assert float(res.cost) < float(res.initial_cost)
        assert err < 0.5 * err_l2, (err, err_l2)
    else:
        assert err < 0.3 * err_init, (err, err_init)

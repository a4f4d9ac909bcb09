"""Pose-graph optimisation, the SE(3) graph SLAM backend (twin of
`cusift_tpu/optim/posegraph.py`).

Residual per edge (i, j), for world-to-camera T:

    r_e = log( T_meas^-1 * T_i * T_j^-1 ) * w_e

Each LM iteration linearises the graph once.  The per-edge [6, 12]
Jacobians over the two endpoint retractions (the reference's
`jax.jacfwd` of `_edge_residual_12`) follow from the chain rule: with
E = T_meas^-1 T_i T_j^-1, retracting T_i by xi_i and T_j by xi_j moves E
to exp(Ad(T_meas^-1) xi_i - Ad(E) xi_j) E to first order (the derivative
of exp at zero is exact), so only log's derivative at E is taken by
forward mode: one batched pass with dual tensors, each edge repeated 6
times with one basis tangent.

"cg" solves (J^T J + lambda I) dx = -J^T r matrix-free, as the
reference's jvp/vjp do: each round gathers the endpoint steps of every
edge, multiplies them by the edge's [12, 12] block J_e^T J_e and
scatter-adds the products into [N, 6] (`kernels/segment.py:segment_sum`
over the endpoint plan made once per solve: `index_add_` on the CPU, a
kernel on the card that adds in the CPU's order, so reruns are
bit-identical), so its memory is O(E + N).
"dense" lays the blocks out as one J [6E, 6N] (a one-hot product, no
scatter and no atomics) and factors H = J^T J with `cholesky_ex`, which
neither raises nor waits for the device: a factor that fails is NaN, as
the reference's is, and the step is then rejected by the isfinite accept.

The loops are Python loops of fixed length with `torch.where` accept and
reject.  `group` is the twin of the reference's `axis_name`: with a process
group, g's edges are this rank's shard and the poses are replicated; the
costs and the CG's [N, 6] vectors (J^T r, J^T J x) are all-reduced over the
group, so every rank runs the same CG (the dense solver is single-device
only; parallel/dist_pg.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwad

from ..config import PoseGraphConfig
from ..kernels import segment
from ..utils.collective import psum
from ..utils.precision import f32_matmuls
from . import robust
from .lie import compose, hat, inverse, se3_exp, se3_log


class PoseGraph(NamedTuple):
    """Static-capacity pose graph; edge weight 0 disables an edge."""

    poses_r: torch.Tensor   # [N, 3, 3] world-to-camera
    poses_t: torch.Tensor   # [N, 3]
    edge_i: torch.Tensor    # [E] int
    edge_j: torch.Tensor    # [E] int
    meas_r: torch.Tensor    # [E, 3, 3] measured T_i * T_j^-1
    meas_t: torch.Tensor    # [E, 3]
    weight: torch.Tensor    # [E] (sqrt-information scalar)


class PoseGraphResult(NamedTuple):
    poses_r: torch.Tensor
    poses_t: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor


def _edge_errors(g: PoseGraph):
    """Per edge: T_meas^-1 (the retraction of T_i enters E through it) and
    the error E = T_meas^-1 T_i T_j^-1, as (R, t) pairs."""
    ei, ej = g.edge_i.long(), g.edge_j.long()
    rji, tji = inverse(g.poses_r[ej], g.poses_t[ej])
    rrel, trel = compose(g.poses_r[ei], g.poses_t[ei], rji, tji)     # T_i * T_j^-1
    rmi, tmi = inverse(g.meas_r, g.meas_t)
    return (rmi, tmi), compose(rmi, tmi, rrel, trel)


def _residuals(g: PoseGraph) -> torch.Tensor:
    """[E, 6] weighted residuals at g's poses (the reference evaluates them
    at a zero retraction, whose exp is exactly the identity)."""
    _, (rerr, terr) = _edge_errors(g)
    return se3_log(rerr, terr) * g.weight[:, None]


@f32_matmuls
def cost(g: PoseGraph, group=None) -> torch.Tensor:
    """Total weighted cost; with a `group`, g's edges are this rank's shard
    and the sum is all-reduced."""
    c = 0.5 * (_residuals(g) ** 2).sum()
    return psum(c, group) if group is not None else c


def _edge_norms(g: PoseGraph) -> torch.Tensor:
    """UNWEIGHTED per-edge residual norms at the current poses (the robust
    kernel's scale stays in residual units whatever an edge's weight)."""
    return torch.linalg.vector_norm(_residuals(g), dim=-1) / g.weight.clamp(min=1e-12)


def _robust_cost(g: PoseGraph, delta: float, kernel: str, group=None) -> torch.Tensor:
    """Robust cost on per-edge residual norms (delta <= 0: plain L2)."""
    if delta <= 0:
        return cost(g, group)
    # information-weighted robust cost: sum_e w_e^2 rho(||r_e||_unweighted)
    c = (g.weight ** 2 * robust.rho(_edge_norms(g), delta, kernel)).sum()
    return psum(c, group) if group is not None else c


def _adjoint(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 6, 6] adjoint of (R, t) on (v, w) twists: [[R, t^ R], [0, R]]."""
    return torch.cat([torch.cat([r, hat(t) @ r], -1),
                      torch.cat([torch.zeros_like(r), r], -1)], -2)


def edge_jacobians(g: PoseGraph):
    """Per-edge residual [E, 6] and Jacobian [E, 6, 12] at zero retraction
    (columns 0-5: pose i, 6-11: pose j)."""
    e = g.edge_i.shape[0]
    (rmi, tmi), (r0, t0) = _edge_errors(g)
    # d log(exp(d) E) / d d at d = 0: E's tangent along basis twist d is
    # (hat(d_w) R, hat(d_w) t + d_v)
    basis = torch.eye(6, dtype=r0.dtype, device=r0.device).repeat(e, 1)     # [6E, 6]
    r6, t6 = r0.repeat_interleave(6, 0), t0.repeat_interleave(6, 0)
    dw = hat(basis[:, 3:])
    with fwad.dual_level():
        rd = fwad.make_dual(r6, dw @ r6)
        td = fwad.make_dual(t6, (dw @ t6[..., None])[..., 0] + basis[:, :3])
        log0, dlog = fwad.unpack_dual(se3_log(rd, td))
    w = g.weight[:, None, None]
    jlog = w * dlog.reshape(e, 6, 6).transpose(1, 2)            # [E, 6, 6 directions]
    jac = torch.cat([jlog @ _adjoint(rmi, tmi), -(jlog @ _adjoint(r0, t0))], -1)
    return log0.reshape(e, 6, 6)[:, 0] * g.weight[:, None], jac


def _stacked_jacobian(g: PoseGraph, jac: torch.Tensor) -> torch.Tensor:
    """The residual map's Jacobian as one dense [6E, 6N]: edge e's [6, 6]
    blocks in the columns of its poses i and j (summed when i == j)."""
    n = g.poses_r.shape[0]
    ar = torch.arange(n, device=jac.device)
    oi = (g.edge_i.long()[:, None] == ar).to(jac.dtype)            # [E, N]
    oj = (g.edge_j.long()[:, None] == ar).to(jac.dtype)
    full = (oi[:, None, :, None] * jac[:, :, None, :6]
            + oj[:, None, :, None] * jac[:, :, None, 6:])           # [E, 6, N, 6]
    return full.reshape(jac.shape[0] * 6, n * 6)


def _assemble_dense(g_it: PoseGraph):
    """Dense Gauss-Newton system (H [6n, 6n], b [6n]) from per-edge blocks."""
    res, jac = edge_jacobians(g_it)
    j = _stacked_jacobian(g_it, jac)
    return j.T @ j, -(j.T @ res.reshape(-1))


def _cg(matvec, b, iters: int, tol: float):
    """Conjugate gradients of fixed length (tol is unused, as in the
    reference)."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = (r * r).sum()
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        ap = matvec(p)
        denom = (p * ap).sum()
        alpha = torch.where(denom.abs() > 1e-30, rs / denom, zero)
        x = x + alpha * p
        r = r - alpha * ap
        rs2 = (r * r).sum()
        beta = torch.where(rs > 1e-30, rs2 / rs, zero)
        p = r + beta * p
        rs = rs2
    return x


@f32_matmuls
def lm_loop(g: PoseGraph, cfg: PoseGraphConfig, group=None) -> PoseGraphResult:
    """LM on the pose graph; gauge fixed by freezing pose 0 (optional).

    Runs alone (group=None) or on every rank of `group` with the edges
    sharded and the poses replicated."""
    n = g.poses_r.shape[0]
    mask = g.poses_t.new_ones((n, 6))
    if cfg.fix_first_pose:
        mask[0] = 0.0
    flat_mask = mask.reshape(-1)
    delta = cfg.huber_delta
    if cfg.solver not in ("cg", "dense"):
        raise ValueError(f"unknown pose-graph solver {cfg.solver!r}")

    # the dense normal equations are single-device only: with sharded
    # edges their assembly would need an O(N^2) all-reduce
    dense = cfg.solver == "dense" and group is None
    ends = torch.stack([g.edge_i, g.edge_j], 1).long()                     # [E, 2]
    ends_plan = None if dense else segment.plan(ends.reshape(-1), n)

    def psum_(x):
        return psum(x, group) if group is not None else x

    c0 = _robust_cost(g, delta, cfg.robust_kernel, group)
    lam = torch.tensor(cfg.init_damping, dtype=torch.float32, device=c0.device)
    cur = c0
    one = torch.ones((), dtype=c0.dtype, device=c0.device)
    for _ in range(cfg.max_iters):
        if delta > 0:
            # IRLS: sqrt-kernel edge reweighting at the current poses;
            # acceptance evaluates the true robust cost (one objective)
            w_rob = robust.sqrt_weight(_edge_norms(g), delta, cfg.robust_kernel)
            g_it = g._replace(weight=g.weight * w_rob)
        else:
            g_it = g
        if dense:
            h, b = _assemble_dense(g_it)
            # free dofs: not gauge-fixed AND constrained (dead ring slots and
            # weight-0 edges leave zero diagonal blocks); fixed and dead
            # dofs get a unit diagonal and zero rhs => dx = 0 there
            free = (flat_mask > 0) & (torch.diagonal(h) > 1e-12)
            hm = torch.where(free[:, None] & free[None, :], h, torch.zeros_like(h))
            hm = hm + torch.diag(torch.where(free, lam, one))
            bm = torch.where(free, b, torch.zeros_like(b))
            chol, info = torch.linalg.cholesky_ex(hm)
            chol = torch.where(info == 0, chol, torch.full_like(chol, torch.nan))
            dx = torch.cholesky_solve(bm[:, None], chol)[:, 0].reshape(n, 6) * mask
        else:
            res0, jac = edge_jacobians(g_it)
            hblk = jac.transpose(1, 2) @ jac                                 # [E, 12, 12]

            def scatter(y):                     # [E, 12] -> [N, 6], per endpoint
                return segment.segment_sum(y.reshape(-1, 6), ends_plan)

            def normal_mv(x):
                x = x * mask
                jtjx = psum_(scatter((hblk @ x[ends].reshape(-1, 12, 1))[..., 0]))
                return (jtjx + lam * x) * mask

            b = -psum_(scatter((jac.transpose(1, 2) @ res0[..., None])[..., 0])) * mask
            dx = _cg(normal_mv, b, cfg.cg_iters, cfg.cg_tol) * mask
        dr, dt = se3_exp(dx)
        cand = g._replace(poses_r=dr @ g.poses_r,
                          poses_t=(dr @ g.poses_t[..., None])[..., 0] + dt)
        cnew = _robust_cost(cand, delta, cfg.robust_kernel, group)
        accept = torch.isfinite(cnew) & (cnew < cur)
        g = g._replace(poses_r=torch.where(accept, cand.poses_r, g.poses_r),
                       poses_t=torch.where(accept, cand.poses_t, g.poses_t))
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-10, 1e6)
        cur = torch.where(accept, cnew, cur)
    return PoseGraphResult(poses_r=g.poses_r, poses_t=g.poses_t, cost=cur,
                           initial_cost=c0)


def optimize(g: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig()) -> PoseGraphResult:
    """Single-device pose-graph optimisation (the LM loop)."""
    return lm_loop(g, cfg)

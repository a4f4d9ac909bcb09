"""Sim(3) pose-graph optimisation, monocular scale-drift correction (twin
of `cusift_tpu/optim/sim3graph.py`).

Nodes are similarities S_i = (s_i, R_i, t_i) acting X -> s R X + t
(world-to-camera).  Residual per edge (i, j) with measured S_m ~ S_i S_j^-1:

    r_e = [t_err / |t_m|, log_SO3(R_err), log(s_err)] * w_e
    of  S_m^-1 S_i S_j^-1

with the translation block normalised per edge (floored at 5% of the
graph's mean |t_m|) so that edges measured at different chain epochs stay
commensurate.  The retraction is left-multiplicative:
(e^sigma, exp(phi), rho) S_i with xi = [rho, phi, sigma].

Each LM iteration linearises the graph once: the per-edge [7, 14] blocks
(columns 0-6 the retraction of node i, 7-13 of node j; the reference's
`jax.jvp`/`jax.vjp` of the whole residual map) come from one batched
forward-mode pass with dual tensors, each edge repeated 14 times with one
basis tangent.  CG then solves (J^T J + lambda I) dx = -J^T r matrix-free:
each round gathers the endpoint steps, multiplies them by the edge's
[14, 14] block and scatter-adds into [N, 7] (`kernels/segment.py:
segment_sum` over the endpoint plan made once per solve: `index_add_` on
the CPU, a kernel on the card that adds in the CPU's order, so reruns are
bit-identical).  The reference's
`axis_name` (the sharded path) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwad

from ..config import PoseGraphConfig
from ..kernels import segment
from ..utils.precision import f32_matmuls
from . import robust
from .lie import so3_exp, so3_log
from .posegraph import _cg


class Sim3Graph(NamedTuple):
    """Static-capacity Sim(3) graph; edge weight 0 disables an edge."""

    poses_r: torch.Tensor   # [N, 3, 3] world-to-camera rotation
    poses_t: torch.Tensor   # [N, 3]
    poses_s: torch.Tensor   # [N] positive scale (1 = metric anchor)
    edge_i: torch.Tensor    # [E] int
    edge_j: torch.Tensor    # [E] int
    meas_r: torch.Tensor    # [E, 3, 3] measured S_i S_j^-1
    meas_t: torch.Tensor    # [E, 3]
    meas_s: torch.Tensor    # [E] measured relative scale (1 for odometry)
    weight: torch.Tensor    # [E] sqrt-information scalar


class Sim3Result(NamedTuple):
    poses_r: torch.Tensor
    poses_t: torch.Tensor
    poses_s: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor


def sim3_compose(sa, ra, ta, sb, rb, tb):
    """(sa, Ra, ta) o (sb, Rb, tb): apply b first.  X -> sa Ra (sb Rb X + tb) + ta."""
    return sa * sb, ra @ rb, sa[..., None] * (ra @ tb[..., None])[..., 0] + ta


def sim3_inverse(s, r, t):
    rt = r.transpose(-1, -2)
    si = 1.0 / s
    return si, rt, -si[..., None] * (rt @ t[..., None])[..., 0]


def _retract(xi, s, r, t):
    """(e^sigma, exp(phi), rho) o (s, R, t) for xi = [rho, phi, sigma]."""
    return sim3_compose(torch.exp(xi[..., 6]), so3_exp(xi[..., 3:6]), xi[..., :3], s, r, t)


def _tnorm(g: Sim3Graph) -> torch.Tensor:
    """[E, 1] per-edge translation normaliser: |t_m| floored at 5% of the
    mean |t_m| over the active (weight > 0) edges."""
    tmag = torch.linalg.vector_norm(g.meas_t, dim=-1)
    active = (g.weight > 0).to(tmag.dtype)
    mean_t = (tmag * active).sum() / active.sum().clamp(min=1.0)
    return torch.maximum(tmag, 0.05 * mean_t + 1e-9)[..., None]


def _edge_residuals(g: Sim3Graph, xi_i, xi_j, ei, ej, meas, tnorm, weight):
    """[M, 7] weighted residuals of edges (ei, ej) with their endpoint
    retractions xi_i, xi_j [M, 7]; `meas` = (s, R, t) of S_m^-1."""
    si, ri, ti = _retract(xi_i, g.poses_s[ei], g.poses_r[ei], g.poses_t[ei])
    sj, rj, tj = _retract(xi_j, g.poses_s[ej], g.poses_r[ej], g.poses_t[ej])
    srel, rrel, trel = sim3_compose(si, ri, ti, *sim3_inverse(sj, rj, tj))
    serr, rerr, terr = sim3_compose(*meas, srel, rrel, trel)
    res = torch.cat([terr / tnorm, so3_log(rerr), torch.log(serr.clamp(min=1e-12))[..., None]], -1)
    return res * weight[..., None]


def _residuals(xi: torch.Tensor, g: Sim3Graph) -> torch.Tensor:
    """[E, 7] weighted residuals at the retraction xi [N, 7] about g's poses."""
    ei, ej = g.edge_i.long(), g.edge_j.long()
    meas = sim3_inverse(g.meas_s, g.meas_r, g.meas_t)
    return _edge_residuals(g, xi[ei], xi[ej], ei, ej, meas, _tnorm(g), g.weight)


def _residuals_at_poses(g: Sim3Graph) -> torch.Tensor:
    """[E, 7] weighted residuals at g's poses (a zero retraction)."""
    return _residuals(g.poses_t.new_zeros((g.poses_r.shape[0], 7)), g)


@f32_matmuls
def cost(g: Sim3Graph) -> torch.Tensor:
    return 0.5 * (_residuals_at_poses(g) ** 2).sum()


def _edge_norms(g: Sim3Graph) -> torch.Tensor:
    """UNWEIGHTED per-edge residual norms at the current poses (the robust
    kernel's scale stays in residual units whatever an edge's weight)."""
    return (torch.linalg.vector_norm(_residuals_at_poses(g), dim=-1)
            / g.weight.clamp(min=1e-12))


def _robust_cost(g: Sim3Graph, delta: float, kernel: str) -> torch.Tensor:
    """Robust cost on per-edge residual norms (delta <= 0: plain L2)."""
    if delta <= 0:
        return cost(g)
    # information-weighted robust cost: sum_e w_e^2 rho(||r_e||_unweighted)
    return (g.weight ** 2 * robust.rho(_edge_norms(g), delta, kernel)).sum()


def edge_jacobians(g: Sim3Graph):
    """Per-edge residual [E, 7] and Jacobian [E, 7, 14] at zero retraction
    (columns 0-6: node i, 7-13: node j), by forward mode: each edge
    repeated 14 times, each copy carrying one basis tangent."""
    e = g.edge_i.shape[0]
    ei = g.edge_i.long().repeat_interleave(14)
    ej = g.edge_j.long().repeat_interleave(14)
    dt = g.poses_t.dtype
    basis = torch.eye(14, dtype=dt, device=g.poses_t.device).repeat(e, 1)   # [14E, 14]
    meas = tuple(a.repeat_interleave(14, 0)
                 for a in sim3_inverse(g.meas_s, g.meas_r, g.meas_t))
    tnorm = _tnorm(g).repeat_interleave(14, 0)
    weight = g.weight.repeat_interleave(14)
    with fwad.dual_level():
        xi = fwad.make_dual(torch.zeros_like(basis), basis)
        res, dres = fwad.unpack_dual(
            _edge_residuals(g, xi[:, :7], xi[:, 7:], ei, ej, meas, tnorm, weight))
    jac = dres.reshape(e, 14, 7).transpose(1, 2)                          # [E, 7, 14]
    return res.reshape(e, 14, 7)[:, 0], jac


@f32_matmuls
def lm_loop(g: Sim3Graph, cfg: PoseGraphConfig) -> Sim3Result:
    """LM on the Sim(3) graph; node 0's 7 dof (scale included) fix the gauge."""
    n = g.poses_r.shape[0]
    mask = g.poses_t.new_ones((n, 7))
    if cfg.fix_first_pose:
        mask[0] = 0.0
    delta = cfg.huber_delta
    ends = torch.stack([g.edge_i, g.edge_j], 1).long().reshape(-1)          # [2E]
    ends_plan = segment.plan(ends, n)

    def scatter(y):                     # [E, 14] -> [N, 7], per endpoint
        return segment.segment_sum(y.reshape(-1, 7), ends_plan)

    c0 = _robust_cost(g, delta, cfg.robust_kernel)
    lam = torch.tensor(cfg.init_damping, dtype=torch.float32, device=c0.device)
    cur = c0
    for _ in range(cfg.max_iters):
        if delta > 0:
            # IRLS: reweight at the current poses; acceptance evaluates the
            # true robust cost (one objective)
            w_rob = robust.sqrt_weight(_edge_norms(g), delta, cfg.robust_kernel)
            g_it = g._replace(weight=g.weight * w_rob)
        else:
            g_it = g
        res0, jac = edge_jacobians(g_it)
        hblk = jac.transpose(1, 2) @ jac                                  # [E, 14, 14]

        def normal_mv(x, lam=lam, hblk=hblk):
            x = x * mask
            jtjx = scatter((hblk @ x[ends].reshape(-1, 14, 1))[..., 0])
            return (jtjx + lam * x) * mask

        b = -scatter((jac.transpose(1, 2) @ res0[..., None])[..., 0]) * mask
        dx = _cg(normal_mv, b, cfg.cg_iters, cfg.cg_tol) * mask
        s, r, t = _retract(dx, g.poses_s, g.poses_r, g.poses_t)
        cand = g._replace(poses_r=r, poses_t=t, poses_s=s)
        cnew = _robust_cost(cand, delta, cfg.robust_kernel)
        accept = torch.isfinite(cnew) & (cnew < cur)
        g = g._replace(poses_r=torch.where(accept, cand.poses_r, g.poses_r),
                       poses_t=torch.where(accept, cand.poses_t, g.poses_t),
                       poses_s=torch.where(accept, cand.poses_s, g.poses_s))
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-10, 1e6)
        cur = torch.where(accept, cnew, cur)
    return Sim3Result(poses_r=g.poses_r, poses_t=g.poses_t, poses_s=g.poses_s,
                      cost=cur, initial_cost=c0)


def optimize(g: Sim3Graph, cfg: PoseGraphConfig = PoseGraphConfig()) -> Sim3Result:
    """Single-device Sim(3) pose-graph optimisation (the LM loop)."""
    return lm_loop(g, cfg)

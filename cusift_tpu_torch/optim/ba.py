"""Bundle adjustment: Levenberg-Marquardt with a matrix-free Schur
complement and PCG (twin of `cusift_tpu/optim/ba.py`).

The sparse normal equations are never formed.  Per-observation Jacobian
blocks (J_c [2, 6] for a left retraction of the camera, J_p [2, 3] for the
landmark) are analytic: at zero twist the reference's `jacfwd` of the
retracted projection is exactly d proj / d X_c @ [I | -hat(X_c)] and
d proj / d X_c @ R.  Camera blocks U, landmark blocks V and the coupling W
stay per camera, per landmark and per observation, and the reduced camera
system S = U - W V^-1 W^T is applied implicitly inside PCG:

    (S x)_c = (U_c + D) x_c - sum_{o: c(o)=c} W_o V_{p(o)}^-1 t_{p(o)},
    t_p     = sum_{o in p} W_o^T x_{c(o)}

Segment sums: where the observations form the [C, L] grid of a keyframe
window (`BAProblem.grid`: cam_idx = repeat(arange(C), L), pt_idx =
tile(arange(L), C)), a sum by camera or by landmark is a reshape and a
`sum`, exact and deterministic; otherwise `index_add_`, whose CUDA form
adds with atomics, so its bits may change from run to run.

The LM and PCG loops are Python loops of fixed length whose accept and
reject are `torch.where`: nothing in them reads a value back to the host.

`group` is the twin of the reference's `axis_name`: with a process group,
p's observations and landmarks are this rank's shard (every landmark's
observations on one rank), the poses are replicated, and each camera-sized
partial sum (costs, U, b_c, the Schur products) is all-reduced over the
group (`utils/collective.py:psum`), so every rank solves the same camera
system and reaches every collective in step (parallel/dist_ba.py).  With
`group=None` nothing is reduced and the code is the single-device path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed

from ..config import BAConfig
from ..ops.geometry import project
from ..ops.mat3 import inv3_spd
from ..utils.collective import psum
from ..utils.precision import f32_matmuls
from .lie import hat, se3_exp


class BAProblem(NamedTuple):
    """Static-shape BA problem; w == 0 disables an observation."""

    poses_r: torch.Tensor   # [C, 3, 3] world-to-camera rotations
    poses_t: torch.Tensor   # [C, 3]
    points: torch.Tensor    # [L, 3] world landmarks
    intr: torch.Tensor      # [4] fx, fy, cx, cy
    cam_idx: torch.Tensor   # [O] int
    pt_idx: torch.Tensor    # [O] int
    uv: torch.Tensor        # [O, 2] pixel measurements
    w: torch.Tensor         # [O] observation weights (0 = invalid)
    # True when the observations are the [C, L] grid (O = C * L,
    # cam_idx = repeat(arange(C), L), pt_idx = tile(arange(L), C))
    grid: bool = False


class BAResult(NamedTuple):
    poses_r: torch.Tensor
    poses_t: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor          # final weighted cost
    initial_cost: torch.Tensor
    iterations: torch.Tensor


def _seg(x: torch.Tensor, idx: torch.Tensor, n: int, grid: str | None) -> torch.Tensor:
    """segment_sum of x [O, ...] by idx into n rows.  grid "cam" or "pt"
    sums the [C, L] observation grid over its landmarks or its cameras."""
    if grid == "cam":
        return x.reshape(n, -1, *x.shape[1:]).sum(1)
    if grid == "pt":
        return x.reshape(-1, n, *x.shape[1:]).sum(0)
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx.long(), x)


def _grids(p: BAProblem):
    """(camera, landmark) segment-sum forms of p's layout for `_seg`."""
    return ("cam", "pt") if p.grid else (None, None)


def _camera_points(p: BAProblem):
    """Per observation: its camera's rotation [O, 3, 3] and the landmark in
    camera coordinates [O, 3]."""
    r = p.poses_r[p.cam_idx.long()]
    x = p.points[p.pt_idx.long()]
    return r, (r @ x[..., None])[..., 0] + p.poses_t[p.cam_idx.long()]


def _residuals(p: BAProblem) -> torch.Tensor:
    """Per-observation reprojection residual [O, 2]."""
    _, pc = _camera_points(p)
    return project(pc, p.intr[0], p.intr[1], p.intr[2], p.intr[3]) - p.uv


@f32_matmuls
def _residuals_and_jacobians(p: BAProblem):
    """Per-observation residual [O, 2], J_c [O, 2, 6], J_p [O, 2, 3].

    J_c is the derivative along the left retraction (v, w) of the camera
    (X_c -> exp(w) X_c + v), J_p along the landmark's own translation.
    The projection's depth clamp (|z| <= 1e-9) has zero derivative in z,
    as in the reference's `jacfwd`.
    """
    r, pc = _camera_points(p)
    fx, fy, cx, cy = p.intr[0], p.intr[1], p.intr[2], p.intr[3]
    res = project(pc, fx, fy, cx, cy) - p.uv
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    live_z = z.abs() > 1e-9
    zc = torch.where(live_z, z, torch.full_like(z, 1e-9))
    zero = torch.zeros_like(z)
    dz_u = torch.where(live_z, -x * fx / (zc * zc), zero)
    dz_v = torch.where(live_z, -y * fy / (zc * zc), zero)
    dproj = torch.stack([torch.stack([fx / zc, zero, dz_u], -1),
                         torch.stack([zero, fy / zc, dz_v], -1)], -2)   # [O, 2, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    jc = dproj @ torch.cat([eye, -hat(pc)], -1)
    jp = dproj @ r
    return res, jc, jp


def _robust_weights(res: torch.Tensor, w: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber IRLS weights on top of the observation weights."""
    if delta <= 0:
        return w
    nrm = torch.linalg.vector_norm(res, dim=-1)
    return w * torch.clamp(delta / nrm.clamp(min=1e-12), max=1.0)


@f32_matmuls
def cost(p: BAProblem, huber_delta: float = 0.0, group=None) -> torch.Tensor:
    res = _residuals(p)
    res = torch.where((p.w > 0)[:, None], res, torch.zeros_like(res))   # see _mask_dead_obs
    sq = (res ** 2).sum(-1)
    if huber_delta > 0:
        nrm = torch.sqrt(sq.clamp(min=1e-18))
        rho = torch.where(nrm <= huber_delta, sq,
                          2 * huber_delta * nrm - huber_delta ** 2)
    else:
        rho = sq
    c = 0.5 * (p.w * rho).sum()
    return psum(c, group) if group is not None else c


def _mask_dead_obs(w, res, jc, jp):
    """Zero residuals/Jacobians of weight-0 observations BEFORE products.

    A dead slot can sit at z ~ 1e-9 after the projection clamp: its
    Jacobian entries reach ~1e20, so J^T J overflows f32 to inf before the
    zero weight multiplies, and 0 * inf = NaN would poison the window.
    """
    live = (w > 0)[:, None]
    return (torch.where(live, res, torch.zeros_like(res)),
            torch.where(live[..., None], jc, torch.zeros_like(jc)),
            torch.where(live[..., None], jp, torch.zeros_like(jp)))


class _Blocks(NamedTuple):
    u: torch.Tensor      # [C, 6, 6]
    v_inv: torch.Tensor  # [L, 3, 3]
    wo: torch.Tensor     # [O, 6, 3]
    b_c: torch.Tensor    # [C, 6]
    b_p: torch.Tensor    # [L, 3]


@f32_matmuls
def build_blocks(p: BAProblem, damping, huber_delta: float,
                 res=None, jc=None, jp=None, group=None) -> _Blocks:
    """Gauss-Newton blocks with LM damping folded into U and V.

    With a `group`, U is all-reduced later, so each rank adds its share of
    the damping: the reduced camera system carries exactly (damping + eps)
    I whatever the rank count, and the distributed LM steps are the
    single-device ones."""
    if res is None:
        res, jc, jp = _residuals_and_jacobians(p)
    res, jc, jp = _mask_dead_obs(p.w, res, jc, jp)
    c, l = p.poses_r.shape[0], p.points.shape[0]
    gc, gp = _grids(p)
    w = _robust_weights(res, p.w, huber_delta)[:, None, None]     # [O, 1, 1]
    jct = jc.transpose(-1, -2)                                    # [O, 6, 2]
    jpt = jp.transpose(-1, -2)                                    # [O, 3, 2]
    u = _seg(w * (jct @ jc), p.cam_idx, c, gc)                    # [C, 6, 6]
    v = _seg(w * (jpt @ jp), p.pt_idx, l, gp)                     # [L, 3, 3]
    wo = w * (jct @ jp)                                           # [O, 6, 3]
    b_c = -_seg((w * jct @ res[..., None])[..., 0], p.cam_idx, c, gc)
    b_p = -_seg((w * jpt @ res[..., None])[..., 0], p.pt_idx, l, gp)
    # LM damping; the small epsilon keeps unobserved blocks invertible
    eye6 = torch.eye(6, dtype=u.dtype, device=u.device)
    eye3 = torch.eye(3, dtype=u.dtype, device=u.device)
    if group is not None:
        u = u + (damping + 1e-8) / torch.distributed.get_world_size(group) * eye6
    else:
        u = u + (damping + 1e-8) * eye6
    v = v + (damping + 1e-8) * eye3
    # inv3_spd, not the cofactor inv3: a thin-ray landmark block has
    # condition ~1e8+, where the f32 cofactor inverse is wrong by orders
    # of magnitude (ops/mat3.py)
    return _Blocks(u=u, v_inv=inv3_spd(v), wo=wo, b_c=b_c, b_p=b_p)


@f32_matmuls
def schur_matvec(blocks: _Blocks, cam_idx, pt_idx, x, cam_mask, grid: bool = False,
                 group=None):
    """(S x) for camera-delta x [C, 6]; cam_mask [C] fixes gauge poses.

    With a `group`, the camera-sized correction is all-reduced: t_p and the
    V blocks stay on the rank that holds the landmark."""
    gc, gp = ("cam", "pt") if grid else (None, None)
    x = x * cam_mask[:, None]
    t_p = _seg((blocks.wo.transpose(-1, -2) @ x[cam_idx.long()][..., None])[..., 0],
               pt_idx, blocks.v_inv.shape[0], gp)                 # [L, 3]
    y = (blocks.v_inv @ t_p[..., None])[..., 0]                   # [L, 3]
    corr = _seg((blocks.wo @ y[pt_idx.long()][..., None])[..., 0],
                cam_idx, x.shape[0], gc)                          # [C, 6]
    if group is not None:
        corr = psum(corr, group)
    sx = (blocks.u @ x[..., None])[..., 0] - corr
    return sx * cam_mask[:, None]


@f32_matmuls
def reduced_rhs(blocks: _Blocks, cam_idx, pt_idx, cam_mask, grid: bool = False,
                group=None):
    """b~_c = b_c - W V^-1 b_p (the Schur-reduced right-hand side)."""
    gc = "cam" if grid else None
    y = (blocks.v_inv @ blocks.b_p[..., None])[..., 0]            # [L, 3]
    corr = _seg((blocks.wo @ y[pt_idx.long()][..., None])[..., 0],
                cam_idx, blocks.b_c.shape[0], gc)
    if group is not None:
        corr = psum(corr, group)
    return (blocks.b_c - corr) * cam_mask[:, None]


def pcg(matvec, b, precond, iters: int, tol: float):
    """Preconditioned conjugate gradients on the camera system.

    A fixed number of rounds; once converged, a zero step keeps x, r and
    p where they are (the reference's scan has no early exit either).
    """
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum()
    bnorm = torch.sqrt((b * b).sum()).clamp(min=1e-30)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        ap = matvec(p)
        denom = (p * ap).sum()
        alpha = torch.where(denom.abs() > 1e-30, rz / denom, zero)
        alpha = torch.where(done, zero, alpha)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz2 = (r * z).sum()
        beta = torch.where(rz.abs() > 1e-30, rz2 / rz, zero)
        p = torch.where(done, p, z + beta * p)
        rz = torch.where(done, rz, rz2)
        done = done | (torch.sqrt((r * r).sum()) / bnorm < tol)
    return x


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where `a` is not positive definite (the
    reference's factorisation does the same).  `cholesky_ex` neither
    raises nor waits for the device."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info[..., None, None] == 0, l, torch.full_like(l, torch.nan))


@f32_matmuls
def _dense_schur_solve(p: BAProblem, blocks: _Blocks, b, cam_mask,
                       res, jc, huber_delta: float, damping):
    """Explicit [6C, 6C] Schur complement, U-whitened eigen-truncated solve
    (BAConfig.solver="dense").

    The sum S = blockdiag(U) - sum_p A_p V_p^-1 A_p^T is assembled as
    sum_p (U_p - A_p V_p^-1 A_p^T), so the big cancellation between two
    grouped sums never materialises; whitening by the block-diagonal U maps
    the spectrum into [0, 1], and eigencomponents below 1e-3 (the
    directions the landmark reduction made unobservable) are dropped.
    Gauge-fixed camera dofs get zeroed rows/cols and a unit diagonal.
    """
    c = p.poses_r.shape[0]
    l = blocks.v_inv.shape[0]
    if p.grid:     # each (landmark, camera) key holds exactly one observation
        def by_key(x):
            return x.reshape(c, l, *x.shape[1:]).transpose(0, 1)
    else:
        key = p.pt_idx.long() * c + p.cam_idx.long()

        def by_key(x):
            return _seg(x, key, l * c, None).reshape(l, c, *x.shape[1:])
    a = by_key(blocks.wo).reshape(l, c * 6, 3)
    w = _robust_weights(res, p.w, huber_delta)[:, None, None]
    jct = jc.transpose(-1, -2)
    ulc = by_key(w * (jct @ jc))                                  # [L, C, 6, 6]
    eye_c = torch.eye(c, dtype=a.dtype, device=a.device)
    bd = (eye_c[None, :, None, :, None] * ulc[:, :, :, None, :]).reshape(l, 6 * c, 6 * c)
    s_l = bd - (a @ blocks.v_inv) @ a.transpose(-1, -2)
    eye = torch.eye(6 * c, dtype=a.dtype, device=a.device)
    sm = s_l.sum(0) + (damping + 1e-8) * eye
    m = cam_mask.repeat_interleave(6)
    sm = sm * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    um = torch.block_diag(*blocks.u.unbind(0))
    um = um * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    du = torch.sqrt(torch.diagonal(um).clamp(min=1e-30))
    um = um / du[:, None] / du[None, :] + 1e-6 * eye             # Jacobi-equilibrated U
    lu = _cholesky_or_nan(um)
    smw = sm / du[:, None] / du[None, :]
    t1 = torch.linalg.solve_triangular(lu, smw, upper=False)
    t = torch.linalg.solve_triangular(lu, t1.T, upper=False)
    lam, vec = torch.linalg.eigh(t)
    keep = lam > 1e-3
    inv_l = torch.where(keep, 1.0 / torch.where(keep, lam, torch.ones_like(lam)),
                        torch.zeros_like(lam))
    bw = torch.linalg.solve_triangular(lu, (b.reshape(-1) * m / du)[:, None], upper=False)
    dcw = vec @ (inv_l[:, None] * (vec.T @ bw))
    dc = torch.linalg.solve_triangular(lu.T, dcw, upper=True)[:, 0] / du
    return dc.reshape(c, 6) * cam_mask[:, None]


@f32_matmuls
def solve_normal_equations(p: BAProblem, damping, cfg: BAConfig, group=None):
    """One damped GN step: returns (delta_c [C, 6], delta_p [L, 3]).

    With a `group`, U and b_c are all-reduced, every rank solves the same
    camera system by PCG (the dense solver is single-device only) and
    back-substitutes its own landmarks."""
    c = p.poses_r.shape[0]
    res, jc, jp = _mask_dead_obs(p.w, *_residuals_and_jacobians(p))
    blocks = build_blocks(p, damping, cfg.huber_delta, res=res, jc=jc, jp=jp,
                          group=group)
    if group is not None:
        blocks = blocks._replace(u=psum(blocks.u, group), b_c=psum(blocks.b_c, group))
    cam_mask = torch.ones(c, dtype=p.poses_t.dtype, device=p.poses_t.device)
    nfix = max(cfg.num_fixed_poses, 1 if cfg.fix_first_pose else 0)
    if nfix > 0:
        cam_mask[:nfix] = 0.0
    # inv_ex: no error check, so no wait for the device (U is damped)
    u_inv = torch.linalg.inv_ex(blocks.u).inverse

    def precond(r):
        return (u_inv @ r[..., None])[..., 0] * cam_mask[:, None]

    b = reduced_rhs(blocks, p.cam_idx, p.pt_idx, cam_mask, p.grid, group)
    if cfg.solver == "dense" and group is None:
        dc = _dense_schur_solve(p, blocks, b, cam_mask, res, jc,
                                cfg.huber_delta, damping)
    else:
        dc = pcg(lambda x: schur_matvec(blocks, p.cam_idx, p.pt_idx, x, cam_mask, p.grid,
                                        group),
                 b, precond, cfg.cg_iters, cfg.cg_tol)

    # back-substitute landmarks: dp = V^-1 (b_p - W^T dc)
    _, gp = _grids(p)
    dcm = (dc * cam_mask[:, None])[p.cam_idx.long()]
    t_p = _seg((blocks.wo.transpose(-1, -2) @ dcm[..., None])[..., 0],
               p.pt_idx, p.points.shape[0], gp)
    dp = (blocks.v_inv @ (blocks.b_p - t_p)[..., None])[..., 0]
    return dc, dp


@f32_matmuls
def apply_step(p: BAProblem, dc, dp) -> BAProblem:
    dr, dt = se3_exp(dc)                                  # [C, 3, 3], [C, 3]
    r2 = dr @ p.poses_r
    t2 = (dr @ p.poses_t[..., None])[..., 0] + dt
    return p._replace(poses_r=r2, poses_t=t2, points=p.points + dp)


@f32_matmuls
def lm_loop(p: BAProblem, cfg: BAConfig, group=None) -> BAResult:
    """LM with a static iteration count, accept/reject by `torch.where`.

    Runs alone (group=None) or on every rank of `group` with sharded
    observations and landmarks and replicated poses; the accept decision
    reads the all-reduced cost, so the ranks stay in step."""
    c0 = cost(p, cfg.huber_delta, group)
    lam = torch.tensor(cfg.init_damping, dtype=torch.float32, device=c0.device)
    cur = c0
    its = torch.zeros((), dtype=torch.int64, device=c0.device)
    for _ in range(cfg.max_iters):
        dc, dp = solve_normal_equations(p, lam, cfg, group)
        cand = apply_step(p, dc, dp)
        cnew = cost(cand, cfg.huber_delta, group)
        accept = torch.isfinite(cnew) & (cnew < cur)
        p = p._replace(**{f: torch.where(accept, getattr(cand, f), getattr(p, f))
                          for f in ("poses_r", "poses_t", "points")})
        lam = torch.where(accept, lam * cfg.damping_down, lam * cfg.damping_up)
        lam = lam.clamp(1e-10, 1e6)
        cur = torch.where(accept, cnew, cur)
        its = its + accept.to(its.dtype)
    return BAResult(poses_r=p.poses_r, poses_t=p.poses_t, points=p.points,
                    cost=cur, initial_cost=c0, iterations=its)


def bundle_adjust(p: BAProblem, cfg: BAConfig = BAConfig()) -> BAResult:
    """Single-device bundle adjustment (the LM loop)."""
    return lm_loop(p, cfg)

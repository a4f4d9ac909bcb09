"""Trajectory evaluation, ATE and RPE in the TUM RGB-D conventions (a numpy
copy of `camera_centers`, `horn_align`, `ate_rmse` and `rpe` from
`cusift_tpu/data/evaluation.py`).

ATE aligns the estimated camera centres to ground truth with the
closed-form rigid (or similarity) fit and reports the RMSE of the
residuals; RPE measures local drift over a fixed frame delta.
"""

from __future__ import annotations

import numpy as np


def camera_centers(poses_r: np.ndarray, poses_t: np.ndarray) -> np.ndarray:
    """World-to-camera (R, t) -> camera centres c = -R^T t, [N, 3]."""
    return -np.einsum("nij,ni->nj", np.asarray(poses_r), np.asarray(poses_t))


def horn_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Closed-form alignment est -> gt.  Returns (s, R, t)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    cov = gc.T @ ec / len(est)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    if with_scale:
        var_e = (ec ** 2).sum() / len(est)
        s = float(np.trace(np.diag(d) @ s_mat) / var_e) if var_e > 0 else 1.0
    else:
        s = 1.0
    t = mu_g - s * r @ mu_e
    return s, r, t


def ate_rmse(est_r, est_t, gt_r, gt_t, with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of aligned camera centres), metres."""
    ce = camera_centers(est_r, est_t)
    cg = camera_centers(gt_r, gt_t)
    s, r, t = horn_align(ce, cg, with_scale)
    resid = (s * ce @ r.T + t) - cg
    return float(np.sqrt((resid ** 2).sum(-1).mean()))


def rpe(est_r, est_t, gt_r, gt_t, delta: int = 1):
    """Relative pose error over frame delta: (trans_rmse_m, rot_rmse_rad)."""
    est_r, est_t = np.asarray(est_r), np.asarray(est_t)
    gt_r, gt_t = np.asarray(gt_r), np.asarray(gt_t)
    terrs, rerrs = [], []
    for i in range(len(est_r) - delta):
        # relative motions T_i T_{i+d}^-1 for est and gt
        re = est_r[i] @ est_r[i + delta].T
        te = est_t[i] - re @ est_t[i + delta]
        rg = gt_r[i] @ gt_r[i + delta].T
        tg = gt_t[i] - rg @ gt_t[i + delta]
        rd = re.T @ rg
        td = re.T @ (tg - te)
        terrs.append(td @ td)
        ang = np.arccos(np.clip((np.trace(rd) - 1) / 2, -1.0, 1.0))
        rerrs.append(ang ** 2)
    return float(np.sqrt(np.mean(terrs))), float(np.sqrt(np.mean(rerrs)))

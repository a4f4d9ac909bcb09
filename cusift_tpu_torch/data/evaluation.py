"""Trajectory evaluation, ATE and RPE in the TUM RGB-D conventions and
KITTI's drift (a numpy copy of `camera_centers`, `horn_align`,
`ate_rmse`, `trajectory_path_length`, `kitti_drift` and `rpe` from
`cusift_tpu/data/evaluation.py`).

ATE aligns the estimated camera centres to ground truth with the
closed-form rigid (or similarity) fit and reports the RMSE of the
residuals; RPE measures local drift over a fixed frame delta; KITTI's
drift averages the relative error over subsequences of fixed path length.
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


def trajectory_path_length(poses_r, poses_t) -> np.ndarray:
    """[N] cumulative path length along the camera-centre trajectory."""
    c = camera_centers(poses_r, poses_t)
    steps = np.linalg.norm(np.diff(c, axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def kitti_drift(est_r, est_t, gt_r, gt_t,
                lengths=(100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0),
                step: int = 10):
    """KITTI odometry drift: (translation %, rotation deg/m).

    Over all subsequences of each path length L (starts every `step`
    frames, L measured along the ground-truth path), the relative-pose
    error between the estimated and true motion, translation normalised
    by L (percent) and rotation by L (deg/m), averaged.  NaN when no
    subsequence is long enough (pass short `lengths` for short sequences).
    """
    est_r, est_t = np.asarray(est_r, np.float64), np.asarray(est_t, np.float64)
    gt_r, gt_t = np.asarray(gt_r, np.float64), np.asarray(gt_t, np.float64)
    dist = trajectory_path_length(gt_r, gt_t)
    n = len(gt_r)

    def rel(r, t, i, j):
        # camera-i-frame motion taking frame-j points to frame-i points
        rr = r[i] @ r[j].T
        return rr, t[i] - rr @ t[j]

    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for length in lengths:
            # the first frame whose ground-truth distance exceeds first's by length
            j = int(np.searchsorted(dist, dist[first] + length))
            if j >= n:
                continue
            re_, te_ = rel(est_r, est_t, first, j)
            rg_, tg_ = rel(gt_r, gt_t, first, j)
            rd = re_.T @ rg_
            td = re_.T @ (tg_ - te_)
            ang = np.arccos(np.clip((np.trace(rd) - 1) / 2, -1.0, 1.0))
            t_errs.append(np.linalg.norm(td) / length)
            r_errs.append(np.degrees(ang) / length)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs) * 100.0), float(np.mean(r_errs))


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

"""Synthetic ground-truth data in numpy + scipy (twin of
`cusift_tpu/data/synthetic.py`): textured images, homography-warped pairs,
the planar RGB-D sequence, and random BA and pose-graph problems.

The reference module imports jax and renders with cv2; this twin needs
neither.  It consumes the same `default_rng(seed)` draws in the same order,
so `h_true` is identical to the reference's for the same seed, and the
images agree up to cv2's own rounding:

* the detail bands use `scipy.ndimage.gaussian_filter` with cv2's kernel
  radius for float images (round(8*sigma + 1) | 1 taps) and reflect-101
  borders (scipy's "mirror");
* the warp samples the source through H^-1 with bilinear interpolation and
  reflect-101 borders, where `cv2.warpPerspective` rounds coordinates to
  1/32 pixel first.

Poses come from a numpy `se3_exp` evaluated in float64 and rounded to
float32, where the reference evaluates its float32 `se3_exp`: they agree
to float32 rounding, and so do the analytic depth maps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy import ndimage

# TUM fr1-like intrinsics (640x480)
DEFAULT_INTR = np.array([517.3, 516.5, 318.6, 255.3], np.float32)


def _hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def se3_exp(xi) -> tuple[np.ndarray, np.ndarray]:
    """[6] twist (v, w) -> float32 (R [3, 3], t [3]), with the reference's
    small-angle Taylor branches (`optim/lie.py`), evaluated in float64."""
    xi = np.asarray(xi, np.float64)
    v, w = xi[:3], xi[3:]
    th = np.sqrt(max(float(w @ w), 1e-24))
    k = _hat(w)
    if th < 1e-4:
        a, b, c = 1.0 - th * th / 6.0, 0.5 - th * th / 24.0, 1.0 / 6.0 - th * th / 120.0
    else:
        a = np.sin(th) / th
        b = (1.0 - np.cos(th)) / th ** 2
        c = (th - np.sin(th)) / th ** 3
    k2 = k @ k
    r = np.eye(3) + a * k + b * k2
    t = (np.eye(3) + b * k + c * k2) @ v
    return r.astype(np.float32), t.astype(np.float32)


def _warp(img: np.ndarray, h_mat: np.ndarray) -> np.ndarray:
    """cv2.warpPerspective(img, h_mat) with bilinear sampling and
    reflect-101 borders: destination pixel (x, y) samples the source at
    h_mat^-1 (x, y, 1), at exact coordinates."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    src = np.linalg.inv(h_mat) @ np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)])
    sx = (src[0] / src[2]).reshape(h, w)
    sy = (src[1] / src[2]).reshape(h, w)
    return ndimage.map_coordinates(img, [sy, sx], order=1, mode="mirror").astype(np.float32)


def _cv2_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) for a float32 image."""
    ksize = int(round(sigma * 8.0 + 1.0)) | 1
    return ndimage.gaussian_filter(img, sigma, mode="mirror",
                                   radius=(ksize - 1) // 2)


def textured_image(h: int, w: int, seed: int = 0, blobs: int = 160,
                   detail: float = 0.0, detail_octaves: int = 1) -> np.ndarray:
    """Random multi-scale Gaussian-blob texture in [0, 1] (SIFT-friendly).

    detail > 0 adds band-passed noise; detail_octaves > 1 stacks coarser
    octave-spaced bands (1/f-like spectrum) so upper octaves see extrema.
    """
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.15 + 0.1 * (xx / w) + 0.1 * (yy / h)
    for _ in range(blobs):
        cx, cy = rs.uniform(0, w), rs.uniform(0, h)
        s = rs.uniform(2.0, 18.0)
        a = rs.uniform(-0.6, 0.8)
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    if detail > 0:
        for o in range(max(1, detail_octaves)):
            noise = rs.normal(size=(h, w)).astype(np.float32)
            band = (_cv2_blur(noise, 1.2 * 2.0 ** o)
                    - _cv2_blur(noise, 3.0 * 2.0 ** o))
            img += detail * band / max(band.std(), 1e-6)
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def warped_pair(h: int = 480, w: int = 640, seed: int = 0, blobs: int = 160,
                detail: float = 0.0, detail_octaves: int = 1):
    """(img_a, img_b, H_true) with img_b = warp(img_a, H_true)."""
    img = textured_image(h, w, seed=seed, blobs=blobs, detail=detail,
                         detail_octaves=detail_octaves)
    rs = np.random.default_rng(seed + 1)
    ang = rs.uniform(-0.15, 0.15)
    sc = rs.uniform(0.9, 1.1)
    ca, sa = sc * np.cos(ang), sc * np.sin(ang)
    h_true = np.array([
        [ca, -sa, rs.uniform(-20, 20) + (1 - ca) * w / 2 + sa * h / 2],
        [sa, ca, rs.uniform(-20, 20) - sa * w / 2 + (1 - ca) * h / 2],
        [rs.uniform(-5e-5, 5e-5), rs.uniform(-5e-5, 5e-5), 1.0],
    ], np.float64)
    return img, _warp(img, h_true), h_true


class RGBDSequence(NamedTuple):
    """Ground-truth RGB-D sequence. Poses are world-to-camera (R, t)."""

    images: np.ndarray     # [F, H, W] float32 in [0, 1]
    depths: np.ndarray     # [F, H, W] float32 metres (0 = invalid)
    poses_r: np.ndarray    # [F, 3, 3]
    poses_t: np.ndarray    # [F, 3]
    intr: np.ndarray       # [4]
    timestamps: np.ndarray  # [F] seconds


def planar_rgbd_sequence(n_frames: int = 12, h: int = 480, w: int = 640,
                         seed: int = 0, plane_depth: float = 2.0,
                         motion_scale: float = 1.0,
                         detail: float = 0.0,
                         depth_noise: float = 0.0,
                         detail_octaves: int = 1) -> RGBDSequence:
    """Camera orbiting in front of a textured plane z = plane_depth (world).

    The plane's image in any camera is an exact homography of the world
    texture (the reference camera at identity sees it unwarped), and the
    depth map is analytic: z(u, v) = plane-ray intersection.  depth_noise
    > 0 perturbs depths with multiplicative Gaussian noise of that
    relative sigma.  detail_octaves > 1 (not in the reference, whose
    texture is detail_octaves = 1) stacks coarser detail bands, as
    `textured_image` does, so that the upper octaves find keypoints too
    and a frame fills most of a 2048-keypoint budget.
    """
    fx, fy, cx, cy = DEFAULT_INTR
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    k_inv = np.linalg.inv(k)
    tex = textured_image(h, w, seed=seed, blobs=260, detail=detail,
                         detail_octaves=detail_octaves)

    rs = np.random.default_rng(seed + 7)
    images, depths, rots, trans, stamps = [], [], [], [], []
    n_w = np.array([0.0, 0.0, 1.0])
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1)
    for f in range(n_frames):
        # smooth trajectory: slow sideways arc + small rotation jitter
        s = f / max(n_frames - 1, 1)
        xi = np.array([
            0.35 * np.sin(2 * np.pi * s) * motion_scale,          # tx
            0.15 * np.sin(4 * np.pi * s + 1.0) * motion_scale,    # ty
            0.10 * np.sin(2 * np.pi * s + 0.5) * motion_scale,    # tz
            0.04 * np.sin(2 * np.pi * s + 2.0) * motion_scale,    # wx
            0.08 * np.sin(2 * np.pi * s) * motion_scale,          # wy
            0.03 * np.sin(4 * np.pi * s) * motion_scale,          # wz
        ])
        r_wc, t_wc = se3_exp(xi)                    # world-to-camera
        # plane n.X = d seen from the identity camera: H = K (R + t n^T / d) K^-1
        h_mat = k @ (r_wc + np.outer(t_wc, n_w) / plane_depth) @ k_inv
        img_f = _warp(tex, h_mat)
        # the plane in camera coordinates: n_c^T X_c = d_c
        n_c = r_wc @ n_w
        d_c = plane_depth + n_c @ t_wc
        denom = rays @ n_c
        depth = np.where(np.abs(denom) > 1e-9, d_c / denom, 0.0)
        depth = np.where(depth > 0.05, depth, 0.0)
        if depth_noise > 0:
            noise = 1.0 + rs.normal(size=depth.shape) * depth_noise
            depth = np.where(depth > 0, np.maximum(depth * noise, 0.0), 0.0)
        images.append(img_f)
        depths.append(depth.astype(np.float32))
        rots.append(r_wc)
        trans.append(t_wc)
        stamps.append(f / 30.0)
    return RGBDSequence(images=np.stack(images), depths=np.stack(depths),
                        poses_r=np.stack(rots).astype(np.float32),
                        poses_t=np.stack(trans).astype(np.float32),
                        intr=DEFAULT_INTR.copy(), timestamps=np.array(stamps))


def ba_problem(seed: int = 0, n_cams: int = 6, n_pts: int = 80,
               pixel_noise: float = 0.5, pose_perturb: float = 0.05,
               point_perturb: float = 0.05):
    """Random BA problem + ground truth (cameras ringed around a point cloud).

    Returns (perturbed BAProblem arrays dict, ground-truth dict); cameras
    0 and 1 stay exact (two fixed poses pin the similarity gauge).
    """
    rs = np.random.default_rng(seed)
    fx, fy, cx, cy = DEFAULT_INTR
    pts = rs.uniform([-1.5, -1.5, 3.0], [1.5, 1.5, 5.0], size=(n_pts, 3))

    rots, trans = [], []
    for c in range(n_cams):
        xi = np.array([
            0.8 * np.sin(2 * np.pi * c / n_cams), 0.3 * np.cos(2 * np.pi * c / n_cams),
            0.1 * rs.normal(),
            0.05 * rs.normal(), 0.05 * rs.normal(), 0.05 * rs.normal()])
        r_np, t_np = se3_exp(xi)
        rots.append(r_np)
        trans.append(t_np)
    rots = np.stack(rots)
    trans = np.stack(trans)

    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    pc = np.einsum("oij,oj->oi", rots[cam_idx], pts[pt_idx]) + trans[cam_idx]
    uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                   pc[:, 1] / pc[:, 2] * fy + cy], -1)
    uv += rs.normal(scale=pixel_noise, size=uv.shape)
    in_img = ((uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0)
              & (uv[:, 1] < 480) & (pc[:, 2] > 0.1))

    rots_p, trans_p = [rots[0], rots[1]], [trans[0], trans[1]]
    for c in range(2, n_cams):
        dr_np, dt_np = se3_exp(rs.normal(scale=pose_perturb, size=6))
        rots_p.append(dr_np @ rots[c])
        trans_p.append(dr_np @ trans[c] + dt_np)
    pts_p = pts + rs.normal(scale=point_perturb, size=pts.shape)

    problem = dict(
        poses_r=np.stack(rots_p).astype(np.float32),
        poses_t=np.stack(trans_p).astype(np.float32),
        points=pts_p.astype(np.float32),
        intr=DEFAULT_INTR.copy(),
        cam_idx=cam_idx.astype(np.int32),
        pt_idx=pt_idx.astype(np.int32),
        uv=uv.astype(np.float32),
        w=in_img.astype(np.float32),
    )
    truth = dict(poses_r=rots, poses_t=trans, points=pts)
    return problem, truth


def pose_ring(n: int = 20, drift: float = 0.02, seed: int = 0):
    """Circular trajectory with drifty odometry + one exact loop closure.

    Returns dict with ground-truth poses, noisy initial poses, and edges
    (odometry chain + closure) for pose-graph tests.
    """
    rs = np.random.default_rng(seed)
    radius = 2.0
    rots, trans = [], []
    for i in range(n):
        a = 2 * np.pi * i / n
        # camera on a circle in the xz plane, yaw following the tangent
        r_np, _ = se3_exp(np.array([0.0, 0, 0, 0, -a, 0]))
        rots.append(r_np)
        trans.append(-r_np @ np.array([radius * np.cos(a), 0.0, radius * np.sin(a)]))
    rots = np.stack(rots)
    trans = np.stack(trans)

    edges_i = np.arange(n - 1)
    edges_j = np.arange(1, n)
    meas_r, meas_t = [], []
    for i, j in zip(edges_i, edges_j):
        # T_i * T_j^-1 with noise
        rrel = rots[i] @ rots[j].T
        trel = trans[i] - rrel @ trans[j]
        dr_np, dt_np = se3_exp(rs.normal(scale=drift, size=6))
        meas_r.append(dr_np @ rrel)
        meas_t.append(dr_np @ trel + dt_np)
    # loop closure n-1 -> 0, exact
    edges_i = np.append(edges_i, n - 1)
    edges_j = np.append(edges_j, 0)
    rrel = rots[n - 1] @ rots[0].T
    meas_r.append(rrel)
    meas_t.append(trans[n - 1] - rrel @ trans[0])

    # initial guess: integrate noisy odometry, T_j = T_rel^-1 * T_i
    rots_0, trans_0 = [rots[0]], [trans[0]]
    for e in range(n - 1):
        rrel, trel = meas_r[e], meas_t[e]
        rots_0.append(rrel.T @ rots_0[-1])
        trans_0.append(rrel.T @ (trans_0[-1] - trel))

    return dict(
        gt_r=rots.astype(np.float32), gt_t=trans.astype(np.float32),
        init_r=np.stack(rots_0).astype(np.float32),
        init_t=np.stack(trans_0).astype(np.float32),
        edge_i=edges_i.astype(np.int32), edge_j=edges_j.astype(np.int32),
        meas_r=np.stack(meas_r).astype(np.float32),
        meas_t=np.stack(meas_t).astype(np.float32),
        weight=np.ones(n, np.float32),
    )

"""Visualisation: keypoint and match overlays, TUM trajectory files (twin
of `cusift_tpu/utils/viz.py`).

The reference draws with cv2's anti-aliased circles and lines; the port
draws one-pixel circles and lines in numpy and writes the PNGs with its
own encoder (`utils/imgcodec.py`), so the overlays show the same marks in
the same colours but their pixels are not cv2's.  Arrays are BGR, as the
reference returns them; the PNG files hold RGB.
"""

from __future__ import annotations

import numpy as np

from .imgcodec import write_png


def _to_u8(img01) -> np.ndarray:
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)


def _gray_to_bgr(img01) -> np.ndarray:
    return np.repeat(_to_u8(img01)[..., None], 3, axis=-1)


def _line(out: np.ndarray, p, q, col) -> None:
    """A one-pixel segment from p to q (x, y), end points included."""
    n = int(max(abs(q[0] - p[0]), abs(q[1] - p[1]))) + 1
    xs = np.rint(np.linspace(p[0], q[0], n)).astype(int)
    ys = np.rint(np.linspace(p[1], q[1], n)).astype(int)
    ok = (xs >= 0) & (xs < out.shape[1]) & (ys >= 0) & (ys < out.shape[0])
    out[ys[ok], xs[ok]] = col


def _circle(out: np.ndarray, c, r: int, col) -> None:
    """A one-pixel circle of radius r around c (x, y)."""
    n = max(8, int(np.ceil(2 * np.pi * r * 2)))
    a = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    xs = np.rint(c[0] + r * np.cos(a)).astype(int)
    ys = np.rint(c[1] + r * np.sin(a)).astype(int)
    ok = (xs >= 0) & (xs < out.shape[1]) & (ys >= 0) & (ys < out.shape[0])
    out[ys[ok], xs[ok]] = col


def _write(path: str, bgr: np.ndarray) -> None:
    write_png(path, np.ascontiguousarray(bgr[..., ::-1]))


def draw_keypoints(img01, feats, path: str | None = None) -> np.ndarray:
    """Valid keypoints as scale-sized circles (green) with orientation
    ticks (orange) from their centres."""
    out = _gray_to_bgr(img01)
    v = _host(feats.valid).astype(bool)
    xs, ys = _host(feats.x)[v], _host(feats.y)[v]
    sig, ang = _host(feats.sigma)[v], _host(feats.orientation)[v]
    for x, y, s, a in zip(xs, ys, sig, ang):
        c = (int(round(float(x))), int(round(float(y))))
        r = max(2, int(round(2 * float(s))))
        _circle(out, c, r, (0, 200, 0))
        tip = (int(round(float(x) + r * np.cos(a))), int(round(float(y) + r * np.sin(a))))
        _line(out, c, tip, (0, 120, 255))
    if path:
        _write(path, out)
    return out


def draw_matches(img_a, feats_a, img_b, feats_b, matches,
                 inliers=None, path: str | None = None, max_lines: int = 200) -> np.ndarray:
    """Side-by-side match lines (green = inlier, red = outlier)."""
    a = _gray_to_bgr(img_a)
    b = _gray_to_bgr(img_b)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    ok = _host(matches.ok).astype(bool)
    idx = _host(matches.idx)
    inl = _host(inliers).astype(bool) if inliers is not None else ok
    xa, ya = _host(feats_a.x), _host(feats_a.y)
    xb, yb = _host(feats_b.x), _host(feats_b.y)
    for i in np.nonzero(ok)[0][:max_lines]:
        j = idx[i]
        col = (0, 200, 0) if inl[i] else (0, 0, 220)
        p = (int(round(float(xa[i]))), int(round(float(ya[i]))))
        q = (int(round(float(xb[j]))) + off, int(round(float(yb[j]))))
        _line(canvas, p, q, col)
    if path:
        _write(path, canvas)
    return canvas


def save_trajectory_tum(path: str, timestamps, poses_r, poses_t):
    """Write a trajectory in TUM format (t tx ty tz qx qy qz qw, cam-to-world)."""
    from scipy.spatial.transform import Rotation
    poses_r = np.asarray(poses_r)
    poses_t = np.asarray(poses_t)
    with open(path, "w") as f:
        for ts, r_wc, t_wc in zip(np.asarray(timestamps), poses_r, poses_t):
            r_cw = r_wc.T
            t_cw = -r_wc.T @ t_wc
            q = Rotation.from_matrix(r_cw).as_quat()  # x y z w
            f.write(f"{ts:.6f} {t_cw[0]:.6f} {t_cw[1]:.6f} {t_cw[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")

"""Write rendered sequences to disk in the TUM RGB-D and KITTI odometry
layouts, so the loaders (`data/tum.py`, `data/kitti.py`) and the CLI read
them as they read the real datasets.  PNGs come from the port's own
encoder (`utils/imgcodec.py`): 8-bit images (TUM's RGB as three equal
channels), 16-bit depth at TUM's 5000 counts a metre.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.imgcodec import write_png
from .tum import DEPTH_SCALE


def _u8(img01) -> np.ndarray:
    return np.clip(np.round(np.asarray(img01) * 255.0), 0, 255).astype(np.uint8)


def _cam_to_world(r_wc, t_wc):
    r_cw = np.asarray(r_wc, np.float64).T
    return r_cw, -r_cw @ np.asarray(t_wc, np.float64)


def write_tum(root: str, images, depths, poses_r, poses_t, timestamps,
              name: str = "rgbd_dataset_freiburg1_synthetic", t0: float = 100.0,
              rgb: bool = True) -> str:
    """A TUM sequence directory `root/name` (the fr1 name makes
    `tum.intrinsics_for` give fr1's intrinsics, the synthetic scenes'):
    rgb/ and depth/ PNGs, rgb.txt, depth.txt (depth stamped 5 ms later) and
    groundtruth.txt (camera-to-world tx ty tz qx qy qz qw, from the
    world-to-camera poses).  Returns the directory."""
    from scipy.spatial.transform import Rotation

    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(d, "depth"), exist_ok=True)
    rgb_lines, dep_lines, gt_lines = [], [], []
    for i in range(len(images)):
        t = t0 + float(timestamps[i])
        img = _u8(images[i])
        write_png(os.path.join(d, "rgb", f"{t:.4f}.png"),
                  np.repeat(img[..., None], 3, -1) if rgb else img)
        dep = np.round(np.asarray(depths[i]) / DEPTH_SCALE)
        if dep.max() >= 65536:
            raise ValueError("depth beyond 13.1 m does not fit TUM's 16-bit PNG")
        write_png(os.path.join(d, "depth", f"{t + 0.005:.4f}.png"), dep.astype(np.uint16))
        rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.png")
        dep_lines.append(f"{t + 0.005:.4f} depth/{t + 0.005:.4f}.png")
        r_cw, t_cw = _cam_to_world(poses_r[i], poses_t[i])
        q = Rotation.from_matrix(r_cw).as_quat()
        gt_lines.append(f"{t:.4f} {t_cw[0]:.6f} {t_cw[1]:.6f} {t_cw[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    for fname, head, lines in (("rgb.txt", "# ts file", rgb_lines),
                               ("depth.txt", "# ts file", dep_lines),
                               ("groundtruth.txt", "# ts tx ty tz qx qy qz qw", gt_lines)):
        with open(os.path.join(d, fname), "w") as f:
            f.write(head + "\n" + "\n".join(lines) + "\n")
    return d


def write_kitti(root: str, images_l, intr, poses_r, poses_t, images_r=None,
                baseline: float = 0.0, seq: str = "00") -> tuple[str, str]:
    """A KITTI odometry sequence `root/sequences/seq`: image_0/ (and
    image_1/ when `images_r` is given) as 8-bit PNGs, calib.txt (P0, and P1
    with P1[0, 3] = -fx * baseline) and `root/poses/seq.txt` (camera-to-
    world 3x4 rows).  Returns (sequence directory, pose file)."""
    d = os.path.join(root, "sequences", seq)
    cams = [("image_0", images_l)] + ([("image_1", images_r)] if images_r is not None else [])
    for cam, imgs in cams:
        os.makedirs(os.path.join(d, cam), exist_ok=True)
        for i, img in enumerate(imgs):
            write_png(os.path.join(d, cam, f"{i:06d}.png"), _u8(img))
    fx, fy, cx, cy = (float(v) for v in intr)
    with open(os.path.join(d, "calib.txt"), "w") as f:
        f.write(f"P0: {fx} 0.0 {cx} 0.0 0.0 {fy} {cy} 0.0 0.0 0.0 1.0 0.0\n"
                f"P1: {fx} 0.0 {cx} {-fx * baseline} 0.0 {fy} {cy} 0.0 0.0 0.0 1.0 0.0\n")
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    pose_file = os.path.join(root, "poses", f"{seq}.txt")
    with open(pose_file, "w") as f:
        for r_wc, t_wc in zip(poses_r, poses_t):
            r_cw, t_cw = _cam_to_world(r_wc, t_wc)
            m = np.concatenate([r_cw, t_cw[:, None]], axis=1)
            f.write(" ".join(f"{v:.9f}" for v in m.reshape(-1)) + "\n")
    return d, pose_file

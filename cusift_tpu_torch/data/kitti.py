"""KITTI odometry loader (twin of `cusift_tpu/data/kitti.py`; BASELINE
configs[4]).

Standard layout: ``sequences/<NN>/image_0/######.png`` (grayscale left),
``calib.txt`` (P0 projection), ``poses/<NN>.txt`` (ground-truth cam-to-world
3x4).  Images decode through `utils/native_loader.py` (the native
prefetcher, or the numpy decoder where it does not build), never cv2.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def _floats(text: str) -> np.ndarray:
    """The numbers of a whitespace-separated line (empty if one is not)."""
    try:
        return np.array([float(v) for v in text.split()])
    except ValueError:
        return np.zeros(0)


def available(seq_dir: str) -> bool:
    return os.path.isdir(os.path.join(seq_dir, "image_0"))


def load_calib(seq_dir: str) -> np.ndarray:
    """[4] = fx, fy, cx, cy from the P0 line of calib.txt."""
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            if line.startswith("P0:"):
                p = _floats(line[3:]).reshape(3, 4)
                return np.array([p[0, 0], p[1, 1], p[0, 2], p[1, 2]], np.float32)
    raise ValueError("no P0 in calib.txt")


def stereo_available(seq_dir: str) -> bool:
    return (os.path.isdir(os.path.join(seq_dir, "image_0"))
            and os.path.isdir(os.path.join(seq_dir, "image_1")))


def load_baseline(seq_dir: str) -> float:
    """Rectified rig baseline in metres: b = -P1[0,3] / P1[0,0].

    KITTI's grayscale right camera P1 encodes the baseline as
    P1[0,3] = -fx * b (projection of the rectified right camera).
    """
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            if line.startswith("P1:"):
                p = _floats(line[3:]).reshape(3, 4)
                return float(-p[0, 3] / p[0, 0])
    raise ValueError("no P1 in calib.txt")


def load_stereo(seq_dir: str, max_frames: int | None = None,
                stride: int = 1,
                use_native: bool = True) -> Iterator[tuple]:
    """(left, right) grayscale frame pairs in [0, 1] (image_0/image_1)."""
    left = load_images(seq_dir, max_frames, stride, use_native,
                       camera="image_0")
    right = load_images(seq_dir, max_frames, stride, use_native,
                        camera="image_1")
    yield from zip(left, right)


def load_images(seq_dir: str, max_frames: int | None = None,
                stride: int = 1,
                use_native: bool = True,
                camera: str = "image_0") -> Iterator[np.ndarray]:
    """Grayscale frames of one camera in [0, 1].

    Decoded by `utils/native_loader.FrameStream` (see data/tum.py:load_tum).
    """
    d = os.path.join(seq_dir, camera)
    names = sorted(os.listdir(d))[::stride]
    if max_frames:
        names = names[:max_frames]
    paths = [os.path.join(d, n) for n in names]

    from ..utils import native_loader
    stream = native_loader.FrameStream(paths, backend=None if use_native else "numpy")
    try:
        yield from stream
    finally:
        stream.close()


def load_poses(pose_file: str):
    """Ground truth: list of (R_wc, t_wc) world-to-camera poses."""
    out = []
    for line in open(pose_file):
        v = _floats(line)
        if v.size != 12:
            continue
        m = v.reshape(3, 4)           # cam-to-world
        r_cw, t_cw = m[:, :3], m[:, 3]
        out.append((r_cw.T.astype(np.float32),
                    (-r_cw.T @ t_cw).astype(np.float32)))
    return out

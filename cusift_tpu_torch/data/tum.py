"""TUM RGB-D dataset loader (twin of `cusift_tpu/data/tum.py`; BASELINE
configs[2]-[3]).

Standard TUM fr1/fr2 layout: ``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt``
with timestamped file lists; RGB and depth streams are associated by nearest
timestamp (the dataset's own association convention, max 0.02 s offset).
Depth PNGs are 16-bit with scale 1/5000 m.  Images decode through
`utils/native_loader.py` (the native prefetcher, or the numpy decoder
where it does not build), never cv2.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

DEPTH_SCALE = 1.0 / 5000.0

# factory intrinsics per sequence family
INTRINSICS = {
    "fr1": np.array([517.3, 516.5, 318.6, 255.3], np.float32),
    "fr2": np.array([520.9, 521.0, 325.1, 249.7], np.float32),
    "fr3": np.array([535.4, 539.2, 320.1, 247.6], np.float32),
}


class TumFrame(NamedTuple):
    timestamp: float
    image: np.ndarray   # [H, W] float32 in [0, 1]
    depth: np.ndarray   # [H, W] float32 metres (0 = invalid)


def _read_list(path: str) -> list[tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rest = line.split(maxsplit=1)
            out.append((float(ts), rest.strip()))
    return out


def associate(a: list, b: list, max_dt: float = 0.02) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association of two time-sorted lists.

    np.searchsorted per query instead of the naive O(|a|*|b|) sweep — a
    full fr2 sequence has ~3k entries per stream, where the quadratic form
    spends tens of seconds before the first frame decodes.  All candidates
    inside the max_dt window are considered (not just the two nearest
    indices), so used-up neighbours fall back to the next-closest stamp
    like the original full scan did.
    """
    tb_raw = np.array([t for t, _ in b])
    # searchsorted needs sorted timestamps; _read_list preserves file order,
    # so sort explicitly and map candidates back to original indices (an
    # unsorted association file would otherwise silently yield wrong pairs).
    order = np.argsort(tb_raw, kind="stable")
    tb = tb_raw[order]
    pairs = []
    used = set()
    for i, (ta, _) in enumerate(a):
        lo = int(np.searchsorted(tb, ta - max_dt))
        hi = int(np.searchsorted(tb, ta + max_dt, side="right"))
        best, best_dt = -1, max_dt
        for cand in range(lo, hi):
            orig = int(order[cand])
            if orig in used:
                continue
            dt = abs(tb[cand] - ta)
            if dt <= best_dt:
                best, best_dt = orig, dt
        if best >= 0:
            pairs.append((i, best))
            used.add(best)
    return pairs


def intrinsics_for(seq_dir: str) -> np.ndarray:
    name = os.path.basename(os.path.normpath(seq_dir))
    for k, v in INTRINSICS.items():
        if k in name:
            return v.copy()
    return INTRINSICS["fr1"].copy()


def available(seq_dir: str) -> bool:
    return (os.path.exists(os.path.join(seq_dir, "rgb.txt"))
            and os.path.exists(os.path.join(seq_dir, "depth.txt")))


def load_tum(seq_dir: str, max_frames: int | None = None,
             stride: int = 1, use_native: bool = True) -> Iterator[TumFrame]:
    """Yield associated RGB-D frames.

    Decoding goes through `utils/native_loader.FrameStream`: the native
    threaded prefetcher (in-process PNG decode + worker pool, so disk
    latency hides behind the device) when it builds and `use_native`,
    else the numpy decoder on a thread pool.  Grayscale is the Rec. 601
    luminance of the RGB file, in [0, 1].
    """
    rgb = _read_list(os.path.join(seq_dir, "rgb.txt"))
    dep = _read_list(os.path.join(seq_dir, "depth.txt"))
    pairs = associate(rgb, dep)[::stride]
    if max_frames:
        pairs = pairs[:max_frames]

    from ..utils import native_loader
    backend = None if use_native else "numpy"
    rgb_paths = [os.path.join(seq_dir, rgb[i][1]) for i, _ in pairs]
    dep_paths = [os.path.join(seq_dir, dep[j][1]) for _, j in pairs]
    rgb_stream = native_loader.FrameStream(rgb_paths, backend=backend)
    dep_stream = native_loader.FrameStream(dep_paths, scale=DEPTH_SCALE, backend=backend)
    try:
        for (i, _), img, d in zip(pairs, rgb_stream, dep_stream):
            yield TumFrame(timestamp=rgb[i][0], image=img, depth=d)
    finally:
        rgb_stream.close()
        dep_stream.close()


def load_groundtruth(seq_dir: str):
    """[(t, R_wc [3,3], t_wc [3])] world-to-camera poses from groundtruth.txt.

    The file stores camera-to-world (tx ty tz qx qy qz qw); we invert.
    """
    from scipy.spatial.transform import Rotation
    rows = []
    with open(os.path.join(seq_dir, "groundtruth.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            r_cw = Rotation.from_quat(v[4:8]).as_matrix()   # cam-to-world
            t_cw = np.array(v[1:4])
            r_wc = r_cw.T
            t_wc = -r_cw.T @ t_cw
            rows.append((v[0], r_wc.astype(np.float32), t_wc.astype(np.float32)))
    return rows

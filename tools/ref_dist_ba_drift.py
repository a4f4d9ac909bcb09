"""How far the JAX package's own 2-device `dist_ba=True` run moves from
its single-device run: the reference's side of `tools/dist_ba_drift.py`.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/ref_dist_ba_drift.py [--scene slam|vo]

Runs `tests/test_torch_slam_dist.py`'s scene through `cusift_tpu` on the
CPU with 8 virtual devices (as `tests/conftest.py` sets them up): `slam`,
`Slam` on the 10-frame 240x320 planar RGB-D orbit; `vo`, `MonoVO` with a
4-keyframe window on the 6-frame two-plane sequence.  Once with
`dist_ba=False`, once with `dist_ba=True` and the window BA's mesh cut to
2 of the 8 devices (`map_mesh(2)`; the package's own default takes all 8).
Prints each frame's distance between the two trajectories and both ATEs,
then one JSON object, with the initial and final cost of every distributed
window solve (which shows the 2-device path ran).

The port's windows in both packages are held by
`tests/test_torch_slam_dist.py::test_last_window_sensitivity_shared_with_reference`.
Imports JAX, so it is a tool and not part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("slam", "vo"), default="slam")
    ap.add_argument("--ranks", type=int, default=2, help="devices on the map axis")
    a = ap.parse_args()

    import jax
    import numpy as np

    from cusift_tpu.config import RansacConfig, SiftConfig, SlamConfig
    from cusift_tpu.data.evaluation import ate_rmse
    from cusift_tpu.data.synthetic import planar_rgbd_sequence, two_plane_sequence
    from cusift_tpu.models.odometry import MonoVO
    from cusift_tpu.models.slam import Slam
    from cusift_tpu.parallel import dist_ba
    from cusift_tpu.parallel.mesh import map_mesh

    solves = []          # (initial, final) cost of every distributed window BA
    plain = dist_ba.window_ba_dist

    def counted(*args, **kw):
        out = plain(*args, **kw)
        solves.append([float(out[2]), float(out[3])])
        return out

    dist_ba.window_ba_dist = counted
    if jax.device_count() < a.ranks:
        sys.exit(f"{jax.device_count()} devices: --ranks {a.ranks} needs more")
    t0 = time.perf_counter()
    if a.scene == "slam":
        seq = planar_rgbd_sequence(n_frames=10, h=240, w=320, seed=2, motion_scale=0.6)
        sift = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
        ransac = RansacConfig(num_hypotheses=512, inlier_thresh_3d=0.03)
        slam_cfg = SlamConfig(max_keyframes=16, loop_temporal_gap=50)

        def run(dist):
            slam = Slam(seq.intr, sift, ransac_cfg=ransac, slam_cfg=slam_cfg, dist_ba=dist)
            if dist:
                slam._ba_mesh = map_mesh(a.ranks)
            slam.run(zip(seq.images, seq.depths))
            return slam.trajectory()
        scale = False
    else:
        seq = two_plane_sequence(n_frames=6, h=240, w=320, seed=3, motion_scale=0.8)
        sift = SiftConfig(max_kpts=512, max_kpts_per_octave=384, num_octaves=4)
        ransac = RansacConfig(inlier_thresh_epi=4e-3)

        def run(dist):
            vo = MonoVO(seq.intr, sift, ransac_cfg=ransac, ba_window=4, ba_every=1,
                        dist_ba=dist)
            if dist:
                vo._ba_mesh = map_mesh(a.ranks)
            return vo.run(list(seq.images))
        scale = True

    r0, t0_ = run(False)
    r1, t1 = run(True)
    moved = np.linalg.norm(np.asarray(t1) - np.asarray(t0_), axis=-1)
    ate = [ate_rmse(np.asarray(r), np.asarray(t), seq.poses_r, seq.poses_t, with_scale=scale)
           for r, t in ((r0, t0_), (r1, t1))]
    print("frame distance:", " ".join(f"{m:.6f}" for m in moved))
    print(json.dumps(dict(package="cusift_tpu", scene=a.scene, ranks=a.ranks,
                          devices=jax.device_count(), moved=[float(m) for m in moved],
                          max_moved=float(moved.max()), dist_window_solves=solves,
                          ate_single=float(ate[0]),
                          ate_dist=float(ate[1]), seconds=time.perf_counter() - t0)))


if __name__ == "__main__":
    main()

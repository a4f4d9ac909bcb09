"""Where a 2-rank `dist_ba=True` run parts from the single-device one.

    PYTHONPATH=. python tools/dist_ba_drift.py [--scene slam|vo] [--cg N]

Runs `tests/test_torch_slam_dist.py`'s scene (`slam`: `Slam` on the
10-frame 240x320 planar RGB-D orbit; `vo`: `MonoVO` with a 4-keyframe
window on the 6-frame two-plane sequence) on the CPU twice: in this
process with `dist_ba=False`, and on 2 spawned gloo ranks with
`dist_ba=True`.  Every window BA's LM iterations are recorded in both (the
current cost, the candidate's cost, accept or reject, the damping, the
step's largest entry) and printed side by side, with FLIP where the two
runs decide differently; then each frame's distance between the two
trajectories and both ATEs.  --cg sets the window's PCG rounds (default:
the model's own, 15 for `Slam` and 12 for `MonoVO`).  --threads sets
torch's thread count in this process (the ranks run one thread each).
Prints one JSON object last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

LOG: list = []


def _recording_lm_loop(p, cfg, group=None):
    """`optim/ba.py:lm_loop`, step for step, logging each iteration."""
    from cusift_tpu_torch.optim import ba

    c0 = ba.cost(p, cfg.huber_delta, group)
    lam = torch.tensor(cfg.init_damping, dtype=torch.float32, device=c0.device)
    cur, its, call = c0, torch.zeros((), dtype=torch.int64, device=c0.device), []
    for _ in range(cfg.max_iters):
        dc, dp = ba.solve_normal_equations(p, lam, cfg, group)
        cand = ba.apply_step(p, dc, dp)
        cnew = ba.cost(cand, cfg.huber_delta, group)
        accept = torch.isfinite(cnew) & (cnew < cur)
        call.append(dict(cur=float(cur), cand=float(cnew), accept=bool(accept),
                         damping=float(lam), step=float(dc.abs().max())))
        p = p._replace(**{f: torch.where(accept, getattr(cand, f), getattr(p, f))
                          for f in ("poses_r", "poses_t", "points")})
        lam = torch.where(accept, lam * cfg.damping_down, lam * cfg.damping_up).clamp(1e-10, 1e6)
        cur = torch.where(accept, cnew, cur)
        its = its + accept.to(its.dtype)
    LOG.append(call)
    return ba.BAResult(poses_r=p.poses_r, poses_t=p.poses_t, points=p.points, cost=cur,
                       initial_cost=c0, iterations=its)


def _patch(cg: int | None):
    import cusift_tpu_torch.models.local_ba as local_ba
    import cusift_tpu_torch.models.odometry as odometry
    import cusift_tpu_torch.parallel.dist_ba as dist_ba
    from cusift_tpu_torch.config import BAConfig

    local_ba.lm_loop = dist_ba.lm_loop = _recording_lm_loop
    if cg is not None:      # MonoVO builds its window config in place
        odometry.BAConfig = lambda **kw: BAConfig(**{**kw, "cg_iters": cg})


def _rank_task(device, scene, cg, args):
    from cusift_tpu_torch.parallel import launch

    _patch(cg)
    out = (launch.slam_task if scene == "slam" else launch.vo_task)(device, *args)
    out["log"] = LOG
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("slam", "vo"), default="slam")
    ap.add_argument("--cg", type=int, default=None)
    ap.add_argument("--threads", type=int, default=1)
    a = ap.parse_args()

    from cusift_tpu_torch import RansacConfig, SiftConfig, SlamConfig
    from cusift_tpu_torch.data.evaluation import ate_rmse
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, two_plane_sequence
    from cusift_tpu_torch.models.odometry import MonoVO
    from cusift_tpu_torch.models.slam import Slam
    from cusift_tpu_torch.parallel import launch

    torch.set_num_threads(a.threads)
    _patch(a.cg)
    if a.scene == "slam":
        seq = planar_rgbd_sequence(n_frames=10, h=240, w=320, seed=2, motion_scale=0.6)
        sift = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
        ransac = RansacConfig(num_hypotheses=512, inlier_thresh_3d=0.03)
        slam_cfg = SlamConfig(max_keyframes=16, loop_temporal_gap=50)
        if a.cg is not None:
            slam_cfg = dataclasses.replace(slam_cfg, local_ba_cg_iters=a.cg)
        slam = Slam(seq.intr, sift, ransac_cfg=ransac, slam_cfg=slam_cfg, device="cpu")
        slam.run(zip(seq.images, seq.depths))
        r0, t0 = slam.trajectory()
        args = (seq.intr, list(zip(seq.images, seq.depths)), sift, slam_cfg, ransac)
        scale = False
    else:
        seq = two_plane_sequence(n_frames=6, h=240, w=320, seed=3, motion_scale=0.8)
        sift = SiftConfig(max_kpts=512, max_kpts_per_octave=384, num_octaves=4)
        ransac = RansacConfig(inlier_thresh_epi=4e-3)
        vo = MonoVO(seq.intr, sift, ransac_cfg=ransac, ba_window=4, ba_every=1, device="cpu")
        r0, t0 = vo.run(list(seq.images))
        args = (seq.intr, list(seq.images), sift, ransac, 4, 1, None)
        scale = True
    single = list(LOG)
    two = launch.run(_rank_task, 2, args=(a.scene, a.cg, args), device="cpu", timeout_s=120)
    dist_log = two[0]["log"]

    flips = []
    for k, (calls_a, calls_b) in enumerate(zip(single, dist_log)):
        for i, (x, y) in enumerate(zip(calls_a, calls_b)):
            flip = x["accept"] != y["accept"]
            if flip:
                flips.append([k, i])
            print(f"window {k} iteration {i}: single cost {x['cur']:.9g} -> {x['cand']:.9g} "
                  f"{'accept' if x['accept'] else 'reject'} damping {x['damping']:.3g} "
                  f"step {x['step']:.6g} | 2 ranks {y['cur']:.9g} -> {y['cand']:.9g} "
                  f"{'accept' if y['accept'] else 'reject'} step {y['step']:.6g}"
                  f"{'  FLIP' if flip else ''}")
    moved = np.linalg.norm(np.asarray(two[0]["t"]) - np.asarray(t0), axis=-1)
    ate = [ate_rmse(r, t, seq.poses_r, seq.poses_t, with_scale=scale)
           for r, t in ((r0, t0), (two[0]["r"], two[0]["t"]))]
    print("frame distance:", " ".join(f"{m:.6f}" for m in moved))
    print(json.dumps(dict(scene=a.scene, cg=a.cg, threads=a.threads, windows=len(single),
                          flips=flips, moved=[float(m) for m in moved],
                          ate_single=float(ate[0]), ate_two_ranks=float(ate[1]),
                          ranks_equal=bool(np.array_equal(two[0]["t"], two[1]["t"])))))


if __name__ == "__main__":
    main()

"""Entry points of the port: the two-view step on one device, and a dry run
of every distributed path on n ranks (twins of `__graft_entry__.py`).

    from cusift_tpu_torch import entry
    fn, args = entry.entry()            # on the GPU
    h, inliers, count, matches = fn(*args)
    entry.dryrun_multichip(4)           # four ranks, one process each
"""

from __future__ import annotations

import numpy as np


def entry(device=None):
    """(fn, example_args): the flagship two-view step (BASELINE configs[1]):
    SIFT extract of both frames, ratio-test matching and the batched
    RANSAC homography on `device` (default the GPU), at 480x640 with 1024
    keypoints and 512 hypotheses."""
    from .config import MatchConfig, RansacConfig, SiftConfig
    from .data.synthetic import textured_image
    from .models.twoview import match_pair

    sift_cfg = SiftConfig(max_kpts=1024, max_kpts_per_octave=512)
    match_cfg = MatchConfig()
    ransac_cfg = RansacConfig(num_hypotheses=512)

    def fn(img_a, img_b):
        res = match_pair(img_a, img_b, sift_cfg, match_cfg, ransac_cfg, device=device)
        return (res.homography.h, res.homography.num_inliers,
                res.feats_a.count, res.matches.ok.sum())

    return fn, (textured_image(480, 640, seed=1), textured_image(480, 640, seed=2))


def _dryrun(device) -> dict:
    """Every distribution axis on tiny shapes, on this rank of the default
    group: frame-sharded extraction, the landmark-sharded Schur BA, the
    edge-sharded pose graph, MonoVO and StereoSlam with the distributed
    window BA (the latter against a single-device run of the same scene)."""
    import torch
    import torch.distributed as dist

    from .config import (BAConfig, MeshConfig, PoseGraphConfig, RansacConfig, SiftConfig,
                         SlamConfig)
    from .data.evaluation import ate_rmse
    from .data.synthetic import (ba_problem, pose_ring, textured_image,
                                 two_plane_sequence, two_plane_stereo_sequence)
    from .models.odometry import MonoVO
    from .models.stereo import StereoSlam
    from .optim.posegraph import PoseGraph
    from .parallel.dist_ba import distributed_bundle_adjust, partition_by_landmark
    from .parallel.dist_pg import distributed_pg_optimize, partition_edges
    from .parallel.mesh import make_mesh, map_mesh
    from .parallel.sharded import extract_frames

    n = dist.get_world_size()
    cfg = SiftConfig(max_kpts=128, max_kpts_per_octave=64, num_octaves=2)
    imgs = np.stack([textured_image(96, 128, seed=s, blobs=40) for s in range(n)])
    feats = extract_frames(torch.from_numpy(imgs).to(device), make_mesh(MeshConfig(frames_axis=n, map_axis=1)), cfg)
    assert feats.desc.shape[0] == n

    prob, _ = ba_problem(seed=0, n_cams=4, n_pts=8 * n, pixel_noise=0.3)
    bmesh = map_mesh(n)
    res = distributed_bundle_adjust(partition_by_landmark(prob, n), bmesh,
                                    BAConfig(max_iters=2, cg_iters=8, num_fixed_poses=2),
                                    device=device)
    assert bool(torch.isfinite(res.cost)) and float(res.cost) <= float(res.initial_cost)

    ring = pose_ring(n=2 * n, drift=0.03, seed=1)
    eparts = partition_edges(ring["edge_i"], ring["edge_j"], ring["meas_r"], ring["meas_t"],
                             np.ones(len(ring["edge_i"]), np.float32), n)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    g = PoseGraph(poses_r=t(ring["init_r"]), poses_t=t(ring["init_t"]),
                  **{k: t(v) for k, v in eparts.items()})
    pg = distributed_pg_optimize(g, bmesh, PoseGraphConfig(max_iters=3, cg_iters=10))
    assert bool(torch.isfinite(pg.cost)) and float(pg.cost) <= float(pg.initial_cost)

    seq = two_plane_sequence(n_frames=6, h=96, w=128, seed=2, motion_scale=0.6)
    vo = MonoVO(seq.intr, sift_cfg=cfg, ba_window=4, ba_every=1, dist_ba=True, device=device)
    assert vo._ba_mesh is not None and vo._ba_mesh.shape == (1, n)
    vo.run(iter(seq.images))
    assert sum(1 for s in vo.stats if s["ok"]) >= 3

    # permissive gates: the tiny render carries ~15 keypoints; this checks
    # that the sharded steps run, and the geometry against the scene's
    # ground truth, not bit parity (the chunked run draws its keys in
    # another order and dist_ba takes the split event form)
    sseq = two_plane_stereo_sequence(n_frames=5, h=96, w=128, seed=3, motion_scale=0.5,
                                     amplitude=1.0)
    kw = dict(sift_cfg=cfg, ransac_cfg=RansacConfig(num_hypotheses=256, min_matches=5),
              slam_cfg=SlamConfig(max_keyframes=8, kf_min_inliers=6, track_min_inliers=3,
                                  local_ba_window=3, loop_temporal_gap=50), device=device)
    sslam = StereoSlam(sseq.intr, sseq.baseline, dist_ba=True, **kw)
    assert sslam._ba_mesh is not None
    recs = sslam.run(zip(sseq.images_l, sseq.images_r), chunk=2)
    assert sum(r.get("tracked", True) for r in recs) >= 3
    ref = StereoSlam(sseq.intr, sseq.baseline, dist_ba=False, **kw)
    rrecs = ref.run(zip(sseq.images_l, sseq.images_r), chunk=1)
    assert len(recs) == len(rrecs)
    assert sum(r.get("tracked", True) for r in rrecs) >= 4
    ate_d = float(ate_rmse(*sslam.trajectory(), sseq.poses_r, sseq.poses_t))
    ate_s = float(ate_rmse(*ref.trajectory(), sseq.poses_r, sseq.poses_t))
    assert ate_d < 0.25 and ate_s < 0.25, (
        f"stereo dry run geometry: dist/chunk2 ATE {ate_d:.3f}, single/chunk1 {ate_s:.3f}")
    return dict(ranks=n, kpts=int(feats.valid.sum()), ba_cost=float(res.cost),
                pg_cost=float(pg.cost), vo_ok=sum(1 for s in vo.stats if s["ok"]),
                stereo_ate=(ate_d, ate_s))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run every distributed path on an n-rank mesh (first rank's summary).

    In a job whose default group has n ranks (torchrun) every rank runs it
    in place; in one process with no group, n == 1 runs in place over a
    one-rank group and n > 1 spawns n ranks (`parallel/launch.py`).  NCCL
    with one GPU a rank on `device` "cuda" (the default), gloo on "cpu".
    """
    import torch
    import torch.distributed as dist

    from .parallel import launch
    from .parallel.mesh import DEFAULT_TIMEOUT_S, ensure_group, init_distributed

    dev = torch.device("cuda" if device is None else device)
    if init_distributed(dev) or (n_devices == 1 and not dist.is_initialized()):
        dev = ensure_group(dev)
        if dist.get_world_size() != n_devices:
            raise ValueError(f"need {n_devices} ranks, the job has {dist.get_world_size()}")
        return _dryrun(dev)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"need {n_devices} GPUs, have {torch.cuda.device_count()}")
    return launch.run(_dryrun, n_devices, device=dev.type, timeout_s=DEFAULT_TIMEOUT_S)[0]

"""Command-line tools of the port (twin of `cusift_tpu/cli.py`).

    python -m cusift_tpu_torch.cli demo [--image-a A --image-b B] [--viz PREFIX]
    python -m cusift_tpu_torch.cli slam [--tum DIR | --synthetic N] [--metrics out.jsonl]
    python -m cusift_tpu_torch.cli odo  [--kitti SEQ [--poses P] | --synthetic N] [--loop]
    python -m cusift_tpu_torch.cli stereo [--kitti SEQ | --synthetic N]
    python -m cusift_tpu_torch.cli sfm  [--synthetic N]
    python -m cusift_tpu_torch.cli dist [--ranks N]
    torchrun --nproc-per-node N -m cusift_tpu_torch.cli slam --dist ...

The subcommands, flags and defaults are the reference's, plus `--device`
(cuda, the default, or cpu).  With no input paths, ground-truth synthetic
scenes stand in, so every command runs without a dataset.  Disk frames
decode through `utils/native_loader.py` (the line "decoder: ..." says
which decoder ran).  The last line is the kernel launches of this
process (and of the ranks `dist` spawned), as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _is_main_rank() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _say(*a, **kw):
    """print on the first rank only (every rank of a torchrun job runs the
    same command)."""
    if _is_main_rank():
        print(*a, **kw, flush=True)


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _load_image(path: str) -> np.ndarray:
    from .utils import native_loader

    try:
        return native_loader.decode(path)
    except (ValueError, OSError) as e:
        raise SystemExit(f"cannot read {path} (PNG, PGM/PPM or .npy): {e}") from None


def _corner_error(h_est: np.ndarray, h_true: np.ndarray, h: int, w: int) -> float:
    """Max distance (px) between the image corners mapped by two homographies."""
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64).T

    def xfer(m):
        p = np.asarray(m, np.float64) @ c
        return p[:2] / p[2]

    return float(np.max(np.linalg.norm(xfer(h_est) - xfer(h_true), axis=0)))


def _tum_groundtruth(seq_dir: str, timestamps: list):
    """Ground-truth poses at the frames' timestamps (nearest within 0.02 s),
    or None without groundtruth.txt or when a frame has none."""
    import os

    from .data import tum as tum_mod

    if not os.path.exists(os.path.join(seq_dir, "groundtruth.txt")):
        return None
    rows = tum_mod.load_groundtruth(seq_dir)
    pairs = tum_mod.associate([(t, "") for t in timestamps], [(t, "") for t, _, _ in rows])
    if len(pairs) != len(timestamps):
        return None
    return (np.stack([rows[j][1] for _, j in pairs]), np.stack([rows[j][2] for _, j in pairs]))


def cmd_demo(args):
    from .config import MatchConfig, RansacConfig, SiftConfig
    from .data.synthetic import warped_pair
    from .models.twoview import match_pair
    from .utils import native_loader
    from .utils.image import pad_to_tier

    if args.image_a and args.image_b:
        img_a = _load_image(args.image_a)
        img_b = _load_image(args.image_b)
        _say(f"decoder: {native_loader.decoder()}")
        # canonical shape tiers: arbitrary input sizes share a few input
        # shapes; features landing in the zero-pad apron are masked out
        (img_a, (ha, wa)) = pad_to_tier(img_a)
        (img_b, (hb, wb)) = pad_to_tier(img_b)
    else:
        _say("no images given; using a synthetic ground-truth warped pair")
        img_a, img_b, h_true = warped_pair(480, 640, seed=1, blobs=1200)
        (ha, wa), (hb, wb) = img_a.shape, img_b.shape

    t0 = time.time()
    sift_cfg = SiftConfig(max_kpts=args.max_kpts, max_kpts_per_octave=args.max_kpts // 2)
    res = match_pair(img_a, img_b, sift_cfg, MatchConfig(), RansacConfig(),
                     content_a=(ha, wa), content_b=(hb, wb), device=args.device)
    h = res.homography.h.cpu().numpy()
    _say(f"features A: {int(res.feats_a.count)}   B: {int(res.feats_b.count)}")
    _say(f"matches: {int(res.matches.ok.sum())}   "
         f"inliers: {int(res.homography.num_inliers)}   "
         f"({time.time() - t0:.1f}s incl. build)")
    _say("homography:")
    _say(np.array2string(h, precision=4, suppress_small=True))
    if not (args.image_a and args.image_b):
        _say(f"corner error vs ground truth: {_corner_error(h, h_true, ha, wa):.4f} px")
    if args.viz:
        from .utils.viz import draw_keypoints, draw_matches
        draw_keypoints(img_a, res.feats_a, f"{args.viz}_kpts_a.png")
        draw_keypoints(img_b, res.feats_b, f"{args.viz}_kpts_b.png")
        draw_matches(img_a, res.feats_a, img_b, res.feats_b, res.matches,
                     inliers=res.homography.inliers, path=f"{args.viz}_matches.png")
        _say(f"overlays written to {args.viz}_*.png")


def cmd_slam(args):
    from .config import RansacConfig, SiftConfig, SlamConfig
    from .data import tum as tum_mod
    from .data.evaluation import rpe
    from .data.synthetic import planar_rgbd_sequence
    from .models.slam import Slam
    from .utils import native_loader
    from .utils.logging import JsonlWriter

    writer = JsonlWriter(args.metrics) if args.metrics else None
    timestamps: list[float] = []
    gt = None
    if args.tum:
        if not tum_mod.available(args.tum):
            sys.exit(f"TUM sequence not found at {args.tum}")
        intr = tum_mod.intrinsics_for(args.tum)
        frames = tum_mod.load_tum(args.tum, max_frames=args.frames or None)
        _say(f"decoder: {native_loader.decoder()}")
        seq = None
    else:
        n = args.synthetic or 12
        seq = planar_rgbd_sequence(n_frames=n, h=480, w=640, seed=0, motion_scale=0.8)
        intr = seq.intr
        timestamps = list(seq.timestamps)
        frames = ((seq.images[i], seq.depths[i]) for i in range(n))

    slam = Slam(intr,
                sift_cfg=SiftConfig(max_kpts=args.max_kpts,
                                    max_kpts_per_octave=args.max_kpts // 2),
                ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                slam_cfg=SlamConfig(checkpoint_every=args.checkpoint_every,
                                    local_ba_anchor=args.ba_anchor,
                                    kf_evict=args.kf_evict),
                dist_ba=args.dist, device=args.device)
    t0 = time.time()

    def as_pairs(items):
        for item in items:
            if hasattr(item, "image"):
                timestamps.append(item.timestamp)
                yield (item.image, item.depth)
            else:
                yield item

    def on_metric(rec):      # streamed, so interrupted runs keep metrics
        if writer:
            writer.write(rec)
        if (rec["frame"] + 1) % 10 == 0:
            _say(f"frame {rec['frame'] + 1}: kpts={rec['kpts']} "
                 f"inliers={rec['inliers']} kf={slam.state.n_kf} "
                 f"loops={slam.state.n_closures}")

    slam.on_metric = on_metric
    slam.run(as_pairs(frames))   # pipelined uploads (utils/pipeline.py)
    _sync(slam.device)
    n_frames = len(slam.metrics)
    dt = time.time() - t0
    if writer:
        writer.close()
    extra = (f"; BA sharded over {slam._ba_mesh.shape[1]} rank(s)"
             if slam._ba_mesh is not None else "")
    _say(f"processed {n_frames} frames in {dt:.1f}s "
         f"({n_frames / dt:.2f} frames/s incl. build); "
         f"{slam.state.n_kf} keyframes, {slam.state.n_closures} closures{extra}")
    if seq is not None:
        gt = (seq.poses_r, seq.poses_t)
    elif args.tum:
        gt = _tum_groundtruth(args.tum, timestamps)
    if gt is not None:
        ate = slam.ate(*gt)
        est_r, est_t = slam.trajectory()
        t_rpe, r_rpe = rpe(est_r, est_t, *gt)
        _say(f"ATE RMSE {ate:.4f} m   RPE {t_rpe:.4f} m / {r_rpe:.4f} rad")
    if args.save:
        slam.checkpoint(args.save)
        _say(f"state saved to {args.save}")
    if args.save_trajectory:
        from .utils.viz import save_trajectory_tum
        est_r, est_t = slam.trajectory()
        ts = (timestamps if len(timestamps) == len(est_r)
              else np.arange(len(est_r), dtype=np.float64))
        save_trajectory_tum(args.save_trajectory, ts, est_r, est_t)
        _say(f"trajectory ({len(est_r)} poses, TUM format) "
             f"written to {args.save_trajectory}")


def cmd_stereo(args):
    """Stereo SLAM (BASELINE configs[4] geometry: KITTI supplies stereo).

    Rectified pairs give METRIC per-feature depth (ops/stereo.py), so the
    full RGB-D backend runs at true scale: no Sim(3) layer, no scale
    alignment in the metrics.
    """
    from .config import RansacConfig, SiftConfig, SlamConfig
    from .data import kitti as kitti_mod
    from .data.evaluation import ate_rmse, kitti_drift
    from .data.synthetic import two_plane_stereo_sequence
    from .models.stereo import StereoSlam
    from .utils import native_loader

    gt = None
    if args.kitti:
        if not kitti_mod.stereo_available(args.kitti):
            sys.exit(f"KITTI stereo pair not found at {args.kitti}")
        intr = kitti_mod.load_calib(args.kitti)
        baseline = args.baseline or kitti_mod.load_baseline(args.kitti)
        frames = kitti_mod.load_stereo(args.kitti, max_frames=args.frames or None)
        _say(f"decoder: {native_loader.decoder()}")
        if args.poses:
            poses = kitti_mod.load_poses(args.poses)
            gt = (np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses]))
    else:
        n = args.synthetic or 8
        _say("no dataset given; using a synthetic stereo two-plane scene")
        seq = two_plane_stereo_sequence(n_frames=n, h=240, w=320, seed=0,
                                        motion_scale=0.7, amplitude=2.0)
        intr = seq.intr
        baseline = args.baseline or seq.baseline
        frames = zip(seq.images_l, seq.images_r)
        gt = (seq.poses_r, seq.poses_t)

    slam = StereoSlam(
        intr, baseline,
        sift_cfg=SiftConfig(max_kpts=args.max_kpts, max_kpts_per_octave=args.max_kpts // 2),
        ransac_cfg=RansacConfig(inlier_thresh_3d=0.05),
        slam_cfg=SlamConfig(kf_evict=args.kf_evict), device=args.device)
    t0 = time.time()
    recs = slam.run(frames, max_frames=args.frames or None)
    _sync(slam.device)
    dt = time.time() - t0
    est_r, est_t = slam.trajectory()
    _say(f"processed {len(recs)} frames in {dt:.1f}s "
         f"({len(recs) / dt:.2f} frames/s incl. build); "
         f"{slam.state.n_kf} keyframes, {slam.state.n_closures} closures, "
         f"baseline {baseline:.3f} m")
    if gt is not None:
        n_f = len(est_r)
        gt_r, gt_t = gt[0][:n_f], gt[1][:n_f]
        ate = ate_rmse(est_r, est_t, gt_r, gt_t)   # METRIC: no scale fit
        _say(f"metric ATE RMSE {ate:.4f} m")
        t_pc, r_pc = kitti_drift(est_r, est_t, gt_r, gt_t)
        if np.isfinite(t_pc):
            _say(f"KITTI drift: {t_pc:.2f} % translation, {r_pc:.4f} deg/m rotation")
    if args.save_trajectory:
        np.savetxt(args.save_trajectory, np.concatenate(
            [np.asarray(est_r).reshape(len(est_r), 9), np.asarray(est_t)], -1))
        _say(f"trajectory written to {args.save_trajectory}")


def cmd_sfm(args):
    from .config import BAConfig, RansacConfig, SiftConfig
    from .data.evaluation import ate_rmse
    from .data.synthetic import planar_rgbd_sequence
    from .models.sfm import reconstruct_rgbd

    n = args.synthetic or 8
    seq = planar_rgbd_sequence(n_frames=n, h=480, w=640, seed=0, motion_scale=0.6)
    t0 = time.time()
    rec = reconstruct_rgbd(seq.images, seq.depths, seq.intr,
                           sift_cfg=SiftConfig(max_kpts=args.max_kpts,
                                               max_kpts_per_octave=args.max_kpts // 2),
                           ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                           ba_cfg=BAConfig(huber_delta=4.0, num_fixed_poses=2),
                           device=args.device)
    _say(f"{rec.n_tracks} tracks, {rec.n_obs} observations "
         f"({time.time() - t0:.1f}s incl. build)")
    _say(f"BA cost {float(rec.ba.initial_cost):.1f} -> {float(rec.ba.cost):.1f} "
         f"in {int(rec.ba.iterations)} accepted steps")
    _say(f"ATE RMSE vs ground truth: "
         f"{ate_rmse(rec.poses_r, rec.poses_t, seq.poses_r, seq.poses_t):.4f} m")


def cmd_odo(args):
    """Monocular visual odometry (BASELINE configs[4] frontend).

    --kitti SEQ_DIR runs a KITTI odometry sequence (with --poses for
    ground-truth drift metrics); with no dataset a synthetic two-plane
    scene runs the same pipeline.  --map-anchor raises: the map-anchored
    frontend (models/monomap.py) is not ported yet (ROADMAP queue 1,
    item 11).
    """
    from .config import RansacConfig, SiftConfig, VOConfig
    from .data import kitti as kitti_mod
    from .data.evaluation import ate_rmse, kitti_drift
    from .data.synthetic import two_plane_sequence
    from .models.odometry import MonoVO
    from .utils import native_loader

    gt = None
    if args.kitti:
        if not kitti_mod.available(args.kitti):
            sys.exit(f"KITTI sequence not found at {args.kitti}")
        intr = kitti_mod.load_calib(args.kitti)
        frames = kitti_mod.load_images(args.kitti, max_frames=args.frames or None)
        _say(f"decoder: {native_loader.decoder()}")
        if args.poses:
            poses = kitti_mod.load_poses(args.poses)
            gt = (np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses]))
    else:
        n = args.synthetic or 8
        _say("no dataset given; using a synthetic two-plane scene")
        seq = two_plane_sequence(n_frames=n, h=480, w=640, seed=0)
        intr = seq.intr
        frames = iter(seq.images)
        gt = (seq.poses_r, seq.poses_t)

    vo_cfg = (VOConfig(map_anchor=args.map_anchor, kf_evict=args.kf_evict,
                       sim3_gate=args.sim3_gate)
              if (args.loop or args.map_anchor) else None)
    vo = MonoVO(intr,
                sift_cfg=SiftConfig(max_kpts=args.max_kpts,
                                    max_kpts_per_octave=args.max_kpts // 2),
                ransac_cfg=RansacConfig(),
                ba_window=args.ba_window,
                ba_anchor=args.ba_anchor,
                pad_to_tier=args.tier_pad,
                vo_cfg=vo_cfg, dist_ba=args.dist, device=args.device)
    if args.resume:
        vo.restore(args.resume)
        _say(f"resumed from {args.resume} ({len(vo.poses_r)} frames already tracked)")
    t0 = time.time()
    est_r, est_t = vo.run(frames, max_frames=args.frames or None)
    _sync(vo.device)
    dt = time.time() - t0
    if args.save:     # outside the timing window: npz compression is I/O
        vo.checkpoint(args.save)
        _say(f"state checkpointed to {args.save}")
    n_frames = len(est_r)
    ok = sum(1 for s in vo.stats if s["ok"])
    extra = (f"; {vo.n_kf} keyframes, {vo.n_closures} loop closures" if args.loop else "")
    if args.dist and vo._ba_mesh is not None:
        extra += f"; BA sharded over {vo._ba_mesh.shape[1]} rank(s)"
    _say(f"processed {n_frames} frames in {dt:.1f}s "
         f"({n_frames / dt:.2f} frames/s incl. build); "
         f"{ok}/{len(vo.stats)} pairs tracked{extra}")
    if gt is not None and n_frames > len(gt[0]):
        # a resumed run's trajectory spans more frames than the ground
        # truth fed this invocation; a frame-aligned comparison would lie
        _say(f"skipping gt metrics: {n_frames} estimated frames vs "
             f"{len(gt[0])} ground-truth poses (resumed run?)")
        gt = None
    if gt is not None:
        from .data.evaluation import camera_centers, horn_align, trajectory_path_length
        gt_r, gt_t = gt[0][:n_frames], gt[1][:n_frames]
        ate = ate_rmse(est_r, est_t, gt_r, gt_t, with_scale=True)
        # the monocular trajectory's global scale is arbitrary: apply the
        # Umeyama scale before the drift metric, so the translation-% is
        # drift, not the unobservable global scale offset
        s, _, _ = horn_align(camera_centers(est_r, est_t),
                             camera_centers(gt_r, gt_t), with_scale=True)
        est_t = (est_t * s).astype(np.float32)
        t_pc, r_dpm = kitti_drift(est_r, est_t, gt_r, gt_t)
        if np.isnan(t_pc):
            # shorter than the standard 100..800 m evaluation lengths:
            # fractions of the actual path instead
            total = trajectory_path_length(gt_r, gt_t)[-1]
            if total > 0:
                t_pc, r_dpm = kitti_drift(est_r, est_t, gt_r, gt_t,
                                          lengths=(0.25 * total, 0.5 * total), step=1)
        _say(f"ATE RMSE (Sim3-aligned) {ate:.4f} m")
        _say(f"KITTI drift: {t_pc:.2f} % translation, {r_dpm:.4f} deg/m rotation")
    if args.save_trajectory:
        from .utils.viz import save_trajectory_tum
        save_trajectory_tum(args.save_trajectory, np.arange(n_frames, dtype=np.float64),
                            est_r, est_t)
        _say(f"trajectory written to {args.save_trajectory}")


def _dist_task(device, max_kpts: int):
    """One rank's share of `dist`: frame-sharded extraction of 2 frames a
    rank, then the landmark-sharded Schur BA of 64 landmarks a rank (the
    reference's shapes); times on the first rank's clock."""
    import torch

    from .config import BAConfig, MeshConfig, SiftConfig
    from .data.synthetic import ba_problem, textured_image
    import torch.distributed as dist

    from .parallel.dist_ba import distributed_bundle_adjust, partition_by_landmark
    from .kernels import kernel_counts
    from .parallel.mesh import make_mesh, map_mesh
    from .parallel.sharded import extract_frames

    n = dist.get_world_size()
    cfg = SiftConfig(max_kpts=max_kpts, max_kpts_per_octave=max_kpts // 2, num_octaves=3)
    imgs = torch.from_numpy(np.stack([textured_image(240, 320, seed=s, blobs=120)
                                      for s in range(n * 2)])).to(device)
    mesh = make_mesh(MeshConfig(frames_axis=n, map_axis=1))
    t0 = time.time()
    feats = extract_frames(imgs, mesh, cfg)
    total = int(feats.valid.sum())
    t_extract = time.time() - t0
    d, _ = ba_problem(seed=0, n_cams=8, n_pts=64 * n, pixel_noise=0.4)
    parts = partition_by_landmark(d, n)
    t0 = time.time()
    res = distributed_bundle_adjust(parts, map_mesh(n), BAConfig(max_iters=5, cg_iters=15,
                                                                 num_fixed_poses=2),
                                    device=device)
    c0, c1 = float(res.initial_cost), float(res.cost)
    return dict(t_extract=t_extract, kpts=total, t_ba=time.time() - t0, c0=c0, c1=c1,
                launches=kernel_counts())


def cmd_dist(args):
    """Multi-device pipeline: frame-sharded extraction + distributed Schur BA.

    Spawns one process per device for each count in (1, 2, 4, 8, 16) up to
    the GPUs present (NCCL), or, with --device cpu, up to --ranks gloo
    ranks; prints each count's times so the scaling is visible.  Under
    torchrun it runs once over the job's ranks.
    """
    import torch

    from .parallel import launch
    from .parallel.mesh import init_distributed

    extra = {}
    if init_distributed(args.device):
        import torch.distributed as dist
        dev = torch.device(args.device, torch.cuda.current_device()) \
            if args.device == "cuda" else torch.device("cpu")
        runs = {dist.get_world_size(): [_dist_task(dev, args.max_kpts)]}
    else:
        avail = (torch.cuda.device_count() if args.device == "cuda" else max(1, args.ranks))
        if args.device == "cuda" and args.ranks:
            avail = min(avail, args.ranks)
        if avail < 1:
            sys.exit("dist: no CUDA device (pass --device cpu --ranks N for gloo ranks)")
        runs = {n: launch.run(_dist_task, n, args=(args.max_kpts,), device=args.device)
                for n in (1, 2, 4, 8, 16) if n <= avail}
        for per_rank in runs.values():
            for r in per_rank:
                for k, v in r["launches"].items():
                    extra[k] = extra.get(k, 0) + v
    _say(f"{max(runs)} device(s): {'gpu' if args.device == 'cuda' else 'cpu'}")
    for n, per_rank in runs.items():
        r = per_rank[0]
        _say(f"  extract {n * 2} frames on {n} dev: {r['t_extract']:.2f}s "
             f"(incl. build), {r['kpts']} kpts")
    for n, per_rank in runs.items():
        r = per_rank[0]
        _say(f"  dist-BA {64 * n} landmarks on {n} dev: {r['t_ba']:.2f}s, "
             f"cost {r['c0']:.1f} -> {r['c1']:.1f}")
    return extra


def main(argv=None):
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where the pipeline runs (default: the GPU)")
    ap = argparse.ArgumentParser(prog="cusift_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", parents=[dev], help="two-view extract+match+homography")
    d.add_argument("--image-a")
    d.add_argument("--image-b")
    d.add_argument("--max-kpts", type=int, default=2048)
    d.add_argument("--viz", help="write keypoint/match overlay PNGs with this path prefix")
    d.set_defaults(fn=cmd_demo)

    s = sub.add_parser("slam", parents=[dev], help="RGB-D SLAM over a sequence")
    s.add_argument("--tum", help="TUM sequence directory")
    s.add_argument("--synthetic", type=int, help="use N synthetic frames")
    s.add_argument("--frames", type=int, default=0)
    s.add_argument("--max-kpts", type=int, default=1024)
    s.add_argument("--metrics", help="JSONL metrics output path")
    s.add_argument("--save", help="checkpoint output path")
    s.add_argument("--checkpoint-every", type=int, default=0)
    s.add_argument("--ba-anchor", choices=("newest", "union"), default="newest",
                   help="local-BA landmark anchoring scheme (union "
                        "forces the single-device BA path)")
    s.add_argument("--kf-evict", choices=("redundant", "oldest", "none"),
                   default="redundant",
                   help="keyframe eviction policy once the ring is full "
                        "(redundant keeps spatial coverage; none restores "
                        "the stop-growing behaviour)")
    s.add_argument("--dist", action="store_true",
                   help="shard the local-BA Schur solve over the map axis of "
                        "every rank (torchrun), or of a one-rank group")
    s.add_argument("--save-trajectory", help="write the per-frame trajectory in TUM format")
    s.set_defaults(fn=cmd_slam)

    o = sub.add_parser("odo", parents=[dev], help="monocular visual odometry "
                                                  "(KITTI; BASELINE configs[4] frontend)")
    o.add_argument("--kitti", help="KITTI sequence directory (sequences/NN)")
    o.add_argument("--poses", help="KITTI ground-truth pose file (poses/NN.txt)")
    o.add_argument("--synthetic", type=int, help="use N synthetic frames")
    o.add_argument("--frames", type=int, default=0)
    o.add_argument("--max-kpts", type=int, default=1024)
    o.add_argument("--ba-anchor", choices=("newest", "union"), default="newest",
                   help="windowed-BA landmark anchoring scheme (union "
                        "forces the single-device BA path)")
    o.add_argument("--ba-window", type=int, default=0,
                   help="bundle-adjust the last N frames as they stream (0 = off)")
    o.add_argument("--loop", action="store_true",
                   help="sequence-scale frontend: keyframe ring + loop "
                        "closure + Sim(3) pose graph (bounds long-run drift)")
    o.add_argument("--map-anchor", action="store_true",
                   help="persistent-landmark map + PnP localisation (not "
                        "ported yet: raises NotImplementedError)")
    o.add_argument("--kf-evict", choices=("redundant", "oldest", "none"),
                   default="redundant",
                   help="keyframe eviction policy once the ring is full")
    o.add_argument("--sim3-gate", choices=("speed", "off"), default="speed",
                   help="health gate on each Sim(3) correction solve: "
                        "reject solves whose keyframe speed profile gets "
                        "less uniform than the raw chain's; rejected solves "
                        "keep the last accepted correction")
    o.add_argument("--save", help="checkpoint VO state to this npz at end")
    o.add_argument("--resume", help="restore VO state from this npz first")
    o.add_argument("--dist", action="store_true",
                   help="shard the windowed-BA Schur solve over the map axis "
                        "of every rank (needs --ba-window)")
    o.add_argument("--tier-pad", action="store_true",
                   help="pad frames to canonical shape tiers so mixed "
                        "resolutions share input shapes")
    o.add_argument("--save-trajectory")
    o.set_defaults(fn=cmd_odo)

    st = sub.add_parser("stereo", parents=[dev], help="stereo SLAM/odometry "
                        "(rectified pairs; metric scale)")
    st.add_argument("--kitti", help="KITTI sequence directory (needs image_0 + image_1)")
    st.add_argument("--poses", help="KITTI ground-truth pose file")
    st.add_argument("--synthetic", type=int, help="use N synthetic frames")
    st.add_argument("--frames", type=int, default=0)
    st.add_argument("--max-kpts", type=int, default=1024)
    st.add_argument("--baseline", type=float, default=0.0,
                    help="rig baseline in metres (read from KITTI calib P1 "
                         "when --kitti is given)")
    st.add_argument("--kf-evict", choices=("redundant", "oldest", "none"),
                    default="redundant")
    st.add_argument("--save-trajectory")
    st.set_defaults(fn=cmd_stereo)

    f = sub.add_parser("sfm", parents=[dev], help="small incremental SfM + BA")
    f.add_argument("--synthetic", type=int)
    f.add_argument("--max-kpts", type=int, default=1024)
    f.set_defaults(fn=cmd_sfm)

    g = sub.add_parser("dist", parents=[dev],
                       help="multi-device sharded extract + Schur BA")
    g.add_argument("--max-kpts", type=int, default=256)
    g.add_argument("--ranks", type=int, default=0,
                   help="ranks to go up to (gloo ranks with --device cpu; "
                        "default: every GPU, or 1 on the CPU)")
    g.set_defaults(fn=cmd_dist)

    args = ap.parse_args(argv)
    if getattr(args, "dist", False):
        # join a launcher's group first: under torchrun only rank 0 prints
        from .parallel.mesh import init_distributed
        init_distributed(args.device)
    extra = args.fn(args) or {}
    from .kernels import kernel_counts

    counts = kernel_counts()
    _say("kernel launches: " + json.dumps({k: v + extra.get(k, 0) for k, v in counts.items()}))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""KITTI-00-length endurance run on one GPU: 4,541 synthetic frames through
`StereoSlam` (the twin of `scripts/endurance.py`, which runs the JAX
package).

    python -m cusift_tpu_torch.scripts.endurance [--frames 4541] [--window 500] [--device cpu]

The loop, flags, defaults, window lines and final report are the
reference's, plus --device ("cuda" unless asked for "cpu"; without a GPU
the run stops with an error).  The 300-frame two-plane loop circuit is
tiled, rendered frame by frame as the tracker's feeder thread asks for it
(`utils/pipeline.py`), with a checkpoint and a restore into a fresh
instance at --ckpt-at.  The first stderr line is nvidia-smi's name and
power limit of the card.

The reference's `jit_cache` (compiled-program counts) has no twin.  In its
place the port reports its own fields:

  * `libs`: the distinct shared objects of the port's build directory
    (`cusift_tpu_torch/_build/`: the kernel library `kernels/_build.py:
    library` loads, and the native frame loader) mapped into this
    process, and `so_total`, every shared object mapped, CUDA's own
    modules included;
  * `cuda_mb`: `torch.cuda.memory_allocated()` in MiB at each window
    (None on the CPU), and `cuda_mb_warmup` / `cuda_mb_final` in the final
    report beside `rss_mb_warmup` / `rss_mb_final`.

The reference's docstring states the checks and leaves them to the reader
of its report; here they are asserts, made at the end of the run:

  * no new kernel library after warm-up (`libs` unchanged);
  * device memory growth after warm-up under 64 MiB (skipped on the CPU,
    and the run says so);
  * RSS growth after warm-up under 256 MiB;
  * closures in the last 10% of the run (a window boundary is placed at
    90% of the frames, so the count covers exactly that tail; checked
    only where that tail lies beyond the first circuit, which is where the
    loop first closes);
  * the restored instance finishes: the trajectory covers every frame.

Warm-up ends at the first window boundary at or after 2 x --window frames;
a run shorter than that has no warm-up reading and skips the growth
asserts, and says so.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import SiftConfig, SlamConfig
from ..data.evaluation import ate_rmse, kitti_drift, trajectory_path_length
from ..data.synthetic import (DEFAULT_INTR, _two_plane_pose, _two_plane_render,
                              textured_image)
from ..models.stereo import StereoSlam
from ..utils.device import card_line, entry_device

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
CYCLE = 300                 # frames of the tiled loop circuit
CUDA_GROWTH_MB = 64.0
RSS_GROWTH_MB = 256.0


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return float(line.split()[1]) / 1024.0
    return 0.0


def mapped_libraries() -> tuple[int, int]:
    """(shared objects of the port's build directory, all shared objects)
    mapped into this process."""
    paths = set()
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split(None, 5)
            if len(parts) == 6 and ".so" in os.path.basename(parts[5].strip()):
                paths.add(parts[5].strip())
    ours = sum(1 for p in paths if p.startswith(BUILD_DIR + os.sep))
    return ours, len(paths)


def cuda_mb(dev: torch.device):
    if dev.type != "cuda":
        return None
    return round(torch.cuda.memory_allocated(dev) / 2 ** 20, 1)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m cusift_tpu_torch.scripts.endurance",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4541)
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=320)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--max-keyframes", type=int, default=64)
    ap.add_argument("--window", type=int, default=500, help="frames per timing window")
    ap.add_argument("--ckpt-at", type=int, default=0,
                    help="frame at which to checkpoint+restore (0 = frames//2)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs (default: the GPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = entry_device(args.device, "endurance")
    print(card_line(dev), file=sys.stderr, flush=True)
    ckpt_at = args.ckpt_at or args.frames // 2

    h, w, n = args.h, args.w, args.frames
    intr = DEFAULT_INTR * np.array([w / 640.0, h / 480.0, w / 640.0, h / 480.0], np.float32)
    tex = {-1: textured_image(h, w, seed=3, blobs=300, detail=0.25),
           +1: textured_image(h, w, seed=104, blobs=300, detail=0.25)}
    baseline = 0.12
    tb = np.array([baseline, 0.0, 0.0])

    # Tile the 300-frame loop circuit: the loop path returns to the start
    # pose at s=1, so repeating it is continuous; the camera revisits the
    # same world about n/300 times with the soak's per-frame baseline.
    def pose(f):
        return _two_plane_pose(f % CYCLE, CYCLE, "loop", 0.9, amplitude=6.0)

    def render(f):
        r_wc, t_wc = pose(f)
        img_l, _ = _two_plane_render(r_wc, t_wc, tex, intr, h, w, 3.0, 6.0)
        img_r, _ = _two_plane_render(r_wc, t_wc - tb, tex, intr, h, w, 3.0, 6.0)
        return img_l, img_r

    sift = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
    slam_cfg = SlamConfig(max_keyframes=args.max_keyframes, loop_temporal_gap=8)

    def build():
        return StereoSlam(intr, baseline, sift_cfg=sift, slam_cfg=slam_cfg, device=dev)

    slam = build()
    report = {"frames": n, "chunk": args.chunk, "backend": dev.type, "windows": []}
    window_walls = []
    t_start = time.time()
    f = 0
    tail = math.ceil(0.9 * n)           # the last 10% starts here
    warm = None                         # (rss, cuda, libs) after warm-up
    closures_at_tail = None
    while f < n:
        stop = min(f + args.window, n, ckpt_at if f < ckpt_at else n,
                   tail if f < tail else n)
        t0 = time.time()
        slam.run((render(i) for i in range(f, stop)), chunk=args.chunk)
        wall = time.time() - t0
        window_walls.append((f, stop, wall))
        libs, so_total = mapped_libraries()
        report["windows"].append({
            "frames": [f, stop], "wall_s": round(wall, 1),
            "fps": round((stop - f) / wall, 2), "rss_mb": round(rss_mb(), 1),
            "libs": libs, "so_total": so_total, "cuda_mb": cuda_mb(dev),
            "closures": slam.state.n_closures, "kf_total": slam.state.n_kf_total})
        print(json.dumps(report["windows"][-1]), flush=True)
        f = stop
        if f == tail:
            closures_at_tail = slam.state.n_closures
        if f == ckpt_at:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "endurance_ckpt.npz")
                slam.checkpoint(path)
                slam = build()
                slam.restore(path)
            report["checkpoint_restore_at"] = ckpt_at
            print(json.dumps({"checkpoint_restore": ckpt_at}), flush=True)
        if warm is None and f >= 2 * args.window:
            warm = (rss_mb(), cuda_mb(dev), libs)

    wall_total = time.time() - t_start
    gt_r = np.stack([pose(i)[0] for i in range(n)]).astype(np.float32)
    gt_t = np.stack([pose(i)[1] for i in range(n)]).astype(np.float32)
    er, et = slam.trajectory()
    # restore carries the trajectory from the checkpoint; stitch lengths
    n_est = min(len(er), n)
    ate = ate_rmse(er[-n_est:], et[-n_est:], gt_r[-n_est:], gt_t[-n_est:])
    path_len = float(trajectory_path_length(gt_r, gt_t)[-1])
    t_pc, _ = kitti_drift(er[-n_est:], et[-n_est:], gt_r[-n_est:], gt_t[-n_est:],
                          lengths=(0.25 * path_len, 0.5 * path_len), step=16)
    closures_last10 = slam.state.n_closures - (closures_at_tail or 0)
    steady = [wl for f0, f1, wl in window_walls[2:] if (f1 - f0) == args.window]
    libs, so_total = mapped_libraries()
    report.update(
        wall_s=round(wall_total, 1), fps=round(n / wall_total, 2),
        ate_m=round(float(ate), 3),
        ate_pct_of_path=round(100 * float(ate) / path_len, 2),
        t_drift_pct=round(float(t_pc), 2),
        closures=slam.state.n_closures,
        closures_last10pct=closures_last10,
        kf_total=slam.state.n_kf_total, n_kf=slam.state.n_kf,
        tracked=sum(1 for m in slam.metrics if m.get("tracked", True)),
        rss_mb_warmup=None if warm is None else round(warm[0], 1),
        rss_mb_final=round(rss_mb(), 1),
        cuda_mb_warmup=None if warm is None else warm[1], cuda_mb_final=cuda_mb(dev),
        libs_warmup=None if warm is None else warm[2], libs_final=libs, so_total_final=so_total,
        steady_window_max_over_min=(round(max(steady) / min(steady), 2) if steady else None),
    )
    del report["windows"]
    print(json.dumps(report), flush=True)
    check(report, n_traj=len(er), dev=dev)
    return report


def check(report: dict, n_traj: int, dev: torch.device) -> None:
    """The checks the reference's docstring states, as asserts; the ones a
    run cannot make are named as skipped."""
    n = report["frames"]
    skipped = []
    if n_traj != n:
        raise AssertionError(f"endurance: the trajectory has {n_traj} of {n} frames")
    if "checkpoint_restore_at" not in report and report["frames"] > 0:
        skipped.append("checkpoint/restore (--ckpt-at beyond the run)")
    if report["rss_mb_warmup"] is None:
        skipped.append("growth after warm-up (a run shorter than 2 windows)")
    else:
        if report["libs_final"] != report["libs_warmup"]:
            raise AssertionError(f"endurance: kernel libraries {report['libs_warmup']} after "
                                 f"warm-up, {report['libs_final']} at the end")
        rss = report["rss_mb_final"] - report["rss_mb_warmup"]
        if not rss < RSS_GROWTH_MB:
            raise AssertionError(f"endurance: RSS grew {rss:.1f} MiB after warm-up")
        if dev.type == "cuda":
            grown = report["cuda_mb_final"] - report["cuda_mb_warmup"]
            if not grown < CUDA_GROWTH_MB:
                raise AssertionError(f"endurance: device memory grew {grown:.1f} MiB "
                                     f"after warm-up")
        else:
            skipped.append("device memory growth (a CPU run)")
    if math.ceil(0.9 * n) >= CYCLE:
        if not report["closures_last10pct"] > 0:
            raise AssertionError("endurance: no loop closure in the last 10% of the run")
    else:
        skipped.append(f"closures in the last 10% (the tail starts before frame {CYCLE})")
    print(json.dumps({"checks": "passed", "skipped": skipped}), flush=True)


if __name__ == "__main__":
    main()

"""Drive the port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. device: card name, and nvidia-smi's name and power limit;
  2. build: compile kernels K1-K6 and the segment sum from
     cusift_tpu_torch/csrc with nvcc for sm_90a (one nvcc per source, all
     started together);
  3. K1 against its plain torch version at the octave-0 shape of the bench
     config (L=3, 960x1280, N=3840, S=144, random points within 25 px of
     each slot's centre), timed beside its library yardstick (one
     grid_sample over the gradient volume) and at the path's own
     descriptor and orientation geometries; its bound counts the level
     pixels the points read, not the whole stack;
  4. K2 against its plain torch version at N = M = 6144, plus the
     all-invalid, single-candidate and ragged-N cases; its bound is the
     function's 2*N*M*D at the TF32 tensor-core peak, with the f32 bound
     and the time of the 3xTF32 algorithm's three products beside it;
  5. the two-view main path: `match_pair` on a 480x640 synthetic pair
     with the bench's SiftConfig (upscale, 6144 keypoints) and 1024 RANSAC
     hypotheses, checking the launch counts and the corner-transfer error
     against the true homography, then timing 10 pair runs;
  6. the all-zero image probe;
  7. K3 against its plain version on the octave-0 bases of the 8 bench
     frames [8, 960, 1280] and on one [960, 1280] base, then timed at the
     four octave shapes the batch launches it on (960x1280 down to
     120x160, 8 frames each) and summed per batch;
  8. K4 against its plain version at L=3x960x1280, N=3072, S=144, then
     at the five octave shapes the batch launches it on (level stacks
     3 x 960x1280 down to 3 x 60x80, N = 3072, 1536, 384, 96, 32), each
     timed, the per-frame sum x 8 logged as a per-batch sum beside the
     summed bound;
  9. K5 the same at N = 3840, 1920, 480, 120, 40;
 10. K6 against its plain version at N=3072 on random 12x12 grids, then
     at the orientation grid it serves on the separable path
     (`ops/orientation.py`'s 12 x 12 lattice) at the five octave shapes
     and slot budgets, each timed beside the same grid_sample yardstick,
     its bound counted as K1's; the JSON line's ms and bound are octave
     0's, with the pair's 10 launches summed;
 11. the batched fused-extraction path as bench.py's `bstep` runs it:
     `extract_batch` of 8 frames with fused_pyramid="pallas_hbm" and
     sampler="fused", then `match` of the 7 consecutive pairs; checks the
     launch counts, that the default config's `extract_batch` equals
     `extract` of each frame slot by slot, that the fused features cover
     the default config's on every frame, and the homography of the 4
     true pairs; then times 10 batches of both configurations;
 12. the separable two-view path: `match_pair` with sampler="separable";
 13. RGB-D pair alignment: `align_rgbd_pair` on frames 0 and 2 of
     `planar_rgbd_sequence(8, 480, 640, seed=2, motion_scale=0.6)` with the
     SLAM path's SiftConfig, R and t against ground truth, K1/K2 launches,
     10 timed runs;
 14. the RGB-D SLAM path: `Slam.run` on a 48-frame 480x640 orbit
     (BASELINE configs[3]: 2048 keypoints, a 256-keyframe ring, fused and
     deferred events, 5-keyframe window BA; the texture's detail bands
     fill most of the keypoint slots), checking tracking, keyframes,
     window BA, loop closure and ATE, with frames/s, ms per keyframe event
     and K1/K2 launches per frame and per event (timed through Slam's
     on_metric and on_event hooks, after an untimed 16-frame warm-up), and
     the final map's graph solve timed with each solver; then a 20-frame
     pass with an 8-keyframe ring, where eviction fires;
 15. K1 and K2 at the SLAM path's own inputs, kept from the warm-up: the
     10 K1 calls of one frame's extraction (480x640 levels, no upscale,
     1024 slots an octave) and K2's first tracking and first keyframe-event
     call (2048 x 2048 with the frames' valid masks), each against its
     plain version and timed beside its library yardstick;
 16. chunked RGB-D tracking on phase 14's orbit: one `_chunk_step` of 8
     frames against the bootstrap keyframe, its [8, 22] rows bit for bit
     against 8 sequential `_frame_step` calls with the same generator
     seeds; then `Slam.run(chunk=8)` over the 48 frames (every frame
     tracked, ATE, >= 10 keyframes and fewer than twice phase 14's, one
     fetch of the packed rows a chunk), frames/s beside phase 14's;
 17. a stereo pair at full width: frame 0 of the north-star stereo scene
     (`two_plane_stereo_sequence(150, 480, 640, seed=3, motion_scale=0.9,
     path="loop", amplitude=6.0, blobs=800, detail_octaves=4)`) through
     `_extract_stereo_points` with 2048 keypoints, no upscale: >= 60
     admissible matches, median relative depth error < 0.02 against the
     analytic depth, K1 20 and K2 1 launches, 10 timed runs;
 18. stereo SLAM: `StereoSlam.run` over that scene at chunk 1 and chunk 8
     (`SlamConfig(max_keyframes=48, loop_temporal_gap=12)`), each after an
     untimed warm-up: >= 145 frames tracked, metric ATE (no alignment)
     < 0.04 of the path, KITTI drift < 15%; frames/s with window BA,
     keypoints a frame, keyframes, closures, evictions, ms per event, K1
     and K2 launches a frame and peak device memory;
 19. a mono pair at full width: the stereo scene's left frames 0->1->2
     through `pair_step` (R error < 0.02, >= 60 inliers, K1 10 and K2 1
     a pair; t's angle to the truth printed), `find_pnp` on pair 2's
     chain-scaled points (R < 0.02, t within 20% of the chain-scaled
     truth), 10 timed pair steps, and the Sim(3) graph on
     tests/test_sim3.py's drift loop at that file's three bars, timed;
 20. mono VO: `MonoVO.run` over the scene's 150 left images with the
     reference soak's VOConfig and ba_window 4, after an untimed warm-up:
     >= 90% of pairs tracked, >= 20 keyframes, >= 1 closure, Sim(3)-aligned
     ATE < 15% of the path (the scene's 300 frames are rendered and run if
     no closure fires in 150); frames/s, ms a frame, a keyframe event, a
     Sim(3) solve and a window BA, KITTI drift, the gate log;
 21. SfM: `reconstruct_rgbd` as `cli.py sfm` calls it and
     `reconstruct_mono`, each on 10 frames at 480x640 with 2048 keypoints,
     at tests/test_sfm.py's bars (the mono structure printed, not held);
     `reconstruct_mono` runs twice, and the two agree bit for bit (tracks,
     observations, poses, points: the segment sums are deterministic);
 22. K1 and K2 at the VO path's inputs (a frame's 10 K1 calls, K2's first
     pair-step and loop-verification calls), as phase 15;
 23. the distributed solvers on a one-rank NCCL group on the card:
     `distributed_bundle_adjust` (tests/test_parallel.py:47's problem),
     `window_ba_dist` (a 5-keyframe window of phase 14's orbit at 2048
     keypoints) and `distributed_pg_optimize` (a 24-pose ring) against
     `bundle_adjust`, `window_ba` and `optimize` at the CPU tests'
     tolerances, with the all-reduces per LM iteration and the time of
     one; then the same on 2 and 4 gloo ranks sharing the card (gloo
     stages CUDA tensors through the host, as the phase prints);
 24. `Slam(dist_ba=True)` on phase 14's orbit, one NCCL rank: trajectory
     within 1e-3 m of phase 14's, the same keyframes, frames/s beside it;
 25. the CLI on the card, one subprocess a command at its defaults:
     `demo` (corner error < 2 px), `slam --synthetic 12` (ATE < 0.05 m),
     `odo --synthetic 8 --loop` (>= 90% tracked, Sim(3) ATE < 0.15 of
     the path), `stereo --synthetic 8` (metric ATE < 0.04 of the path),
     `sfm --synthetic 8` (ATE < 0.02 m), `dist`, and `slam --synthetic
     12 --dist` under `torchrun --standalone --nproc-per-node 1` (the
     printed ATE equal to the plain run's);
 26. disk: a 480x640 TUM folder (12 frames, 8-bit RGB and 16-bit depth
     PNGs, associations, ground truth) and a KITTI folder (16 stereo
     frames, calib, poses) written by the port's PNG writer, through
     `slam --tum`, `odo --kitti` and `stereo --kitti` at those bars; the
     decoder that ran and its decode rate;
 27. `entry.entry()` (the two-view step) and `entry.dryrun_multichip(1)`;
 28. the map-anchored mono path: `MonoVO(vo_cfg=VOConfig(map_anchor=True))`
     on phase 20's 150 left images with phase 20's VOConfig and ba_window 4
     and the map at its defaults (8192 landmarks, 512 inserts a keyframe,
     8 observations to mature; `cli.py odo --map-anchor`), after an
     untimed warm-up: >= 90% of frames tracked by the pair or the map,
     Sim(3)-aligned ATE < 15% of the path, keyframe inserts, a map with
     valid landmarks; frames/s, ms a frame, ms of `localize_step` and
     `insert_step`, the share the map localised, the median anchors and
     map/chain scale, K1, K2 and segment-sum launches a frame; then K2 at
     `localize_step`'s first real input (2048 x 8192, the `active` mask)
     against its plain version, timed;
 29. the segment-sum kernel at the inputs phases 20, 21 and 28 gave it
     (the Sim(3) CG's scatter, SfM BA's camera and landmark sums, the
     landmark refinement's): equal bit for bit to its plain version, the
     CPU's `index_add_`, on the same inputs, and within 1e-4 of each
     segment's sum of |x| of `index_add_` on the card (atomics), timed
     beside it and beside `index_put_(accumulate=True)`.
The line before the last is a JSON object with each kernel's launches on
its path (K1's and K2's on phases 23-27 under `new_path_launches`, on
phase 28 under `map_launches`), its error against the plain version, its
times and its bound;
the last line is {"ok": true, "device": {...}}.  Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the bench configuration (bench.py --max-kpts 6144, upscaled 640x480)
BENCH_SIFT = dict(max_kpts=6144, max_kpts_per_octave=3072,
                  octave_budgets=(3072, 1536, 384, 96, 32), upscale=True)
# the bench's batched headline variant (scripts/tpu_batch_r4a.sh)
FUSED = dict(fused_pyramid="pallas_hbm", sampler="fused")
K1_ATOL = 1e-5   # f32, same formula; only FMA contraction differs
# K1/K6's grid_sample yardstick: its normalised coordinates lose digits
# (an f32 ulp of a coordinate near 1 is 8e-5 px at 1280 columns)
LIBRARY_ATOL = 2e-4
K2_ATOL = 1e-5   # f32 dot products of unit vectors, other summation order
K3_ATOL = 1e-5   # f32 blur sums in another order than cuDNN's
K3_MASK = 0.9999  # score masks may differ where a near tie flips
HIST_REL = 1e-4  # K4/K5: sums over 144 samples in another order, atan2f
MAX_CORNER_ERR = 2.0   # px, the two-view drive's bound
# the RGB-D SLAM path (BASELINE configs[3], `cli.py slam` on the synthetic
# orbit): default SiftConfig, 2048 keypoints
SLAM_SIFT = dict(max_kpts=2048, max_kpts_per_octave=1024)
# the orbit: BASELINE configs[3]'s planar sequence, with the detail bands
# that let a frame fill most of its 2048 keypoint slots (the reference
# texture alone fills under a tenth of them)
SLAM_SCENE = dict(seed=5, motion_scale=0.9, detail=0.25, detail_octaves=4)
SLAM_FRAMES = 48
WARMUP_FRAMES = 16      # an untimed first pass over the orbit's start
# keyframe thresholds that make a 48-frame orbit close its loop; the rest
# of SlamConfig stays at its defaults (kf_min_inliers = 60 is the default,
# set for 2048 keypoints)
SLAM_CFG = dict(kf_min_inliers=60, kf_max_translation=0.06, kf_max_rotation=0.06,
                loop_temporal_gap=4, loop_min_score=0.05, loop_min_inliers=25)
RIGID_R_ERR = 0.01     # tests/test_slam.py::test_rgbd_pair_alignment's bounds
RIGID_T_ERR = 0.01     # m
MAX_ATE = 0.05         # m, tests/test_slam.py's loop-closure bound
CHUNK = 8              # the chunked runs' frames a step (tpu_stereo_longrun.py)
# the north-star stereo run (scripts/tpu_stereo_longrun.py:35-36,89-91) at
# the stereo soak's 150 frames (tests/test_stereo.py:105-107), not 300
STEREO_SIFT = dict(max_kpts=2048, max_kpts_per_octave=1024, upscale=False)
STEREO_SCENE = dict(seed=3, motion_scale=0.9, path="loop", amplitude=6.0, blobs=800,
                    detail_octaves=4)
STEREO_FRAMES = 150
STEREO_CHUNK_FRAMES = STEREO_FRAMES   # the chunk-8 run's frames
STEREO_SLAM_CFG = dict(max_keyframes=48, loop_temporal_gap=12)
STEREO_MIN_TRACKED = 145     # tests/test_stereo.py:115-122's soak bounds
STEREO_ATE_OF_PATH = 0.04    # metric ATE, no alignment
STEREO_MAX_DRIFT = 15.0      # KITTI translation %, lengths 0.25 and 0.5 x path
STEREO_MIN_MATCHES = 60      # tests/test_stereo.py:31-65's pair bounds
STEREO_DEPTH_REL = 0.02
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores (same)
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores (same)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# GPU clock cycles the device spins before a timed loop (about 0.1 s)
HOLD_CYCLES = 200_000_000


def time_ms(fn, label: str, iters: int = 20) -> float:
    """Mean device time of fn() in ms over `iters` calls, after a warm-up.

    The device first spins while the host enqueues all the calls, so short
    kernels run back to back and the host's launch overhead is not timed.
    A fn that waits for the device (a plain version's host-to-device copy
    does) or a host slower than the spin leaves gaps in the timed span;
    that is logged as host_gaps for `label`.
    """
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    marks[1].record()
    for _ in range(iters):
        fn()
    marks[2].record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if enqueue_ms >= marks[0].elapsed_time(marks[1]):
        log("timing", label=label, host_gaps=True, enqueue_ms=f"{enqueue_ms:.3f}")
    return marks[1].elapsed_time(marks[2]) / iters


def wall_ms(fn, runs: int, warmup: int = 2) -> list[float]:
    """Host-clock ms of `runs` calls of fn() that end in a synchronise."""
    times = []
    for i in range(runs + warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> dict:
    """Least time for the work: bytes over HBM rate vs ops over `peak`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# f32 operations per sample of the shared bilinear-gradient sampling
# (clip and floor, 8 central differences, two 4-corner interpolations)
SAMPLE_FLOPS = 40
# plus magnitude, atan2 and the fractional bin, for K4 and K5
POLAR_FLOPS = 30


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from cusift_tpu_torch.kernels import matcher, octave, sampler, segment

    sampler.launches = sampler.sep_launches = 0
    sampler.ori_hist_launches = sampler.desc_raw_launches = 0
    matcher.launches = octave.launches = segment.launches = 0


def read_counts() -> dict:
    """Every kernel wrapper's launch count since `reset_counts`."""
    from cusift_tpu_torch.kernels import kernel_counts

    return kernel_counts()


def sample_bytes(gauss, lvl, ys, xs) -> int:
    """Bytes of the level pixels that gradient sampling at (ys, xs) [N, S]
    must read: each distinct pixel of a sample's corners and their central
    differences, once.  Points are clipped as the kernels clip them."""
    l, h, w = gauss.shape
    y = ys.nan_to_num(0.0).clamp(0.0, h - 1.000001)
    x = xs.nan_to_num(0.0).clamp(0.0, w - 1.000001)
    y0 = y.floor().long().clamp(max=h - 2)
    x0 = x.floor().long().clamp(max=w - 2)
    base = lvl.long().clamp(0, l - 1)[:, None] * (h * w)
    reads = [(-1, 0), (-1, 1), (2, 0), (2, 1)] + [(r, c) for r in (0, 1) for c in (-1, 0, 1, 2)]
    idx = torch.cat([base + (y0 + r).clamp(0, h - 1) * w + (x0 + c).clamp(0, w - 1)
                     for r, c in reads], 1)
    return gauss.element_size() * int(torch.unique(idx).numel())


def _points(gen, dev, L, H, W, N, S, spread=25.0):
    """Level stack, per-slot levels and sample points, with samples on the
    borders and outside the image."""
    gauss = torch.from_numpy(gen.random((L, H, W), dtype=np.float32)).to(dev)
    lvl = torch.from_numpy(gen.integers(-1, L + 1, N).astype(np.int32)).to(dev)
    cy = gen.uniform(-20, H + 20, (N, 1))
    cx = gen.uniform(-20, W + 20, (N, 1))
    ys = cy + gen.uniform(-spread, spread, (N, S))
    xs = cx + gen.uniform(-spread, spread, (N, S))
    ys[:8, :8] = 0.0                      # exactly on the borders
    xs[8:16, :8] = W - 1
    ys = torch.from_numpy(ys.astype(np.float32)).to(dev)
    xs = torch.from_numpy(xs.astype(np.float32)).to(dev)
    return gauss, lvl, ys, xs


def orientation_rows(gen, dev, n, L=3, H=960, W=1280):
    """(lvl, ys_rows, xs_cols) of n slots of the orientation grid, as
    `ops/orientation.py:51-55` builds it for K6 (and expands it for K1):
    cfg.ori_grid rows and columns at radius 4.5 sigma_oct x the cell
    centres of [-1, 1], sigma_oct = 1.6 * 2^(so / 3), so uniform in [0, 3),
    around random centres in the image."""
    from cusift_tpu_torch import SiftConfig

    cfg = SiftConfig()
    so = gen.uniform(0, 3, n)
    sigma = cfg.sigma0 * 2.0 ** (so / cfg.scales_per_octave)
    cy, cx = gen.uniform(0, H, (n, 1)), gen.uniform(0, W, (n, 1))
    g = cfg.ori_grid
    c1d = (np.arange(g) + 0.5) / g * 2.0 - 1.0
    span = (cfg.ori_radius_factor * sigma)[:, None] * c1d[None, :]
    lvl = torch.from_numpy(gen.integers(0, L, n).astype(np.int32)).to(dev)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return lvl, as_t(cy + span), as_t(cx + span)


def expand_grid(ys_rows, xs_cols):
    """K6's grid as K1's points [N, GR * GC], point (n, r * GC + c)."""
    n, gr = ys_rows.shape
    gc = xs_cols.shape[1]
    return (ys_rows[:, :, None].expand(n, gr, gc).reshape(n, -1),
            xs_cols[:, None, :].expand(n, gr, gc).reshape(n, -1))


def path_points(gen, dev, kind, L=3, H=960, W=1280):
    """(lvl, ys, xs) of K1's slots on the two-view path at octave 0: the
    descriptor grid of `ops/describe.py` (N = 3840, a 12 x 12 grid rotated
    by theta, cell width 3 sigma_oct) or the orientation grid (N = 3072,
    `orientation_rows` expanded), around random centres, with sigma_oct =
    1.6 * 2^(so / 3), so uniform in [0, 3) and theta in [0, 2 pi)."""
    from cusift_tpu_torch import SiftConfig
    from cusift_tpu_torch.ops.describe import _spatial_weights

    if kind == "orientation":
        lvl, ys_rows, xs_cols = orientation_rows(gen, dev, 3072, L, H, W)
        return (lvl, *(t.contiguous() for t in expand_grid(ys_rows, xs_cols)))
    cfg = SiftConfig()
    n = 3840
    so = gen.uniform(0, 3, n)
    sigma = cfg.sigma0 * 2.0 ** (so / cfg.scales_per_octave)
    cy, cx = gen.uniform(0, H, (n, 1)), gen.uniform(0, W, (n, 1))
    coords = _spatial_weights(cfg.desc_grid, cfg.desc_width)[0].astype(np.float64)
    cell = (cfg.desc_scale_factor * sigma)[:, None]
    th = gen.uniform(0, 2 * np.pi, (n, 1))
    u, v = coords[None, :, 1] * cell, coords[None, :, 0] * cell
    xs = cx + u * np.cos(th) - v * np.sin(th)
    ys = cy + u * np.sin(th) + v * np.cos(th)
    lvl = torch.from_numpy(gen.integers(0, L, n).astype(np.int32)).to(dev)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return lvl, as_t(ys), as_t(xs)


def library_yardstick(tag, gauss, lvl, ys, xs, dx, dy, mask=None) -> dict:
    """K1's and K6's library yardstick: one `grid_sample` over the gradient
    volume [1, 2, L, H, W], whose bilinear weights at an integer level fall
    on that level.  Times the call (the volume built outside it, and timed
    beside it) and holds its output to the plain version's (dx, dy), on
    the samples `mask` marks (all by default)."""
    import torch.nn.functional as F
    from cusift_tpu_torch.ops.gaussian import image_gradients

    l, h, w = gauss.shape
    z = 2.0 * lvl.long().clamp(0, l - 1).float() / max(l - 1, 1) - 1.0
    grid = torch.stack([2.0 * xs / (w - 1) - 1.0, 2.0 * ys / (h - 1) - 1.0,
                        z[:, None].expand_as(xs)], -1)[None, None].contiguous()
    build = lambda: torch.stack(image_gradients(gauss))[None]
    vol = build()
    call = lambda: F.grid_sample(vol, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)
    out = call()[0, :, 0]                                  # [2, N, S]
    m = torch.ones_like(dx, dtype=torch.bool) if mask is None else mask
    err = max((out[0] - dx)[m].abs().max().item(), (out[1] - dy)[m].abs().max().item())
    if not err <= LIBRARY_ATOL:
        raise AssertionError(f"{tag} library: max |err| {err} > {LIBRARY_ATOL}")
    library_ms = time_ms(call, f"{tag} library")
    volume_ms = time_ms(build, f"{tag} library volume")
    log(tag, library="grid_sample", library_ms=f"{library_ms:.4f}",
        volume_ms=f"{volume_ms:.4f}", library_max_abs_err=err)
    return dict(library_ms=library_ms, library_volume_ms=volume_ms, library_max_abs_err=err)


def _k1_case(tag, k1, gauss, lvl, ys, xs) -> dict:
    """K1 once against its plain version (inb equal, atol K1_ATOL on
    in-image samples); returns the outputs, the error and the bound."""
    dx, dy, inb = k1.sample_grad_patches(gauss, lvl, ys, xs)
    rx, ry, rinb = k1.sample_grad_patches_plain(gauss, lvl, ys, xs)
    torch.cuda.synchronize()
    if not torch.equal(inb, rinb):
        raise AssertionError(f"{tag}: inb differs from the plain version")
    err = max((dx - rx)[rinb].abs().max().item(), (dy - ry)[rinb].abs().max().item())
    if not err <= K1_ATOL:
        raise AssertionError(f"{tag}: max |err| {err} > {K1_ATOL}")
    b = bound(sample_bytes(gauss, lvl, ys, xs) + nbytes(lvl, ys, xs, dx, dy, inb),
              SAMPLE_FLOPS * ys.numel())
    return dict(out=(dx, dy, inb), plain=(rx, ry, rinb), max_abs_err=err, bound=b)


def check_sampler(dev, gen: np.random.Generator, L=3, H=960, W=1280,
                  N=3840, S=144) -> dict:
    """K1 vs its plain version and the library's grid_sample at random
    points (border and outside included), then at the path's own
    geometries."""
    from cusift_tpu_torch.kernels import sampler as k1

    gauss, lvl, ys, xs = _points(gen, dev, L, H, W, N, S)
    case = _k1_case("k1", k1, gauss, lvl, ys, xs)
    (dx, dy, inb), (rx, ry, rinb) = case["out"], case["plain"]
    err = case["max_abs_err"]
    ms = time_ms(lambda: k1.sample_grad_patches(gauss, lvl, ys, xs), "k1")
    plain_ms = time_ms(lambda: k1.sample_grad_patches_plain(gauss, lvl, ys, xs), "k1 plain")
    b = case["bound"]
    stack = bound(nbytes(gauss, lvl, ys, xs, dx, dy, inb), SAMPLE_FLOPS * N * S)
    log("k1", shape=f"L{L}x{H}x{W},N{N},S{S}", inb_frac=f"{rinb.float().mean():.4f}",
        max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{b['bound_ms']:.4f}", pct_of_bound=f"{100 * b['bound_ms'] / ms:.1f}",
        whole_stack_bound_ms=f"{stack['bound_ms']:.4f}", card=json.dumps(smi_line()))
    lib = library_yardstick("k1", gauss, lvl, ys, xs, rx, ry)
    log("k1", faster_than_library=ms <= lib["library_ms"])

    geometries = {}
    for kind in ("descriptor", "orientation"):
        plvl, pys, pxs = path_points(gen, dev, kind, L, H, W)
        n = pys.shape[0]
        pc = _k1_case(f"k1 {kind}", k1, gauss, plvl, pys, pxs)
        pms = time_ms(lambda: k1.sample_grad_patches(gauss, plvl, pys, pxs), f"k1 {kind}")
        pb = pc["bound"]
        geometries[kind] = dict(shape=[L, H, W, n, S], ms=pms, max_abs_err=pc["max_abs_err"],
                                **pb)
        log("k1", geometry=kind, shape=f"L{L}x{H}x{W},N{n},S{S}",
            max_abs_err=pc["max_abs_err"], ms=f"{pms:.4f}", bound_ms=f"{pb['bound_ms']:.4f}",
            pct_of_bound=f"{100 * pb['bound_ms'] / pms:.1f}")
    return dict(max_abs_err=max(err, *(g["max_abs_err"] for g in geometries.values())),
                ms=ms, plain_ms=plain_ms, **lib, **b, path_geometries=geometries)


def _unit(gen, n, d=128):
    x = gen.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def check_matcher(dev, gen: np.random.Generator, N=6144, M=6144) -> dict:
    """K2 vs its plain version on the main-path shape and edge cases."""
    from cusift_tpu_torch.kernels import matcher as k2

    a = _unit(gen, N)
    b = _unit(gen, M)
    b[7] = b[3]                          # exact duplicate column: s1 == s2
    a[11] = b[3]
    vb = gen.random(M) > 0.1
    vb[3] = vb[7] = True
    cases = {
        "main": (a, b, vb),
        "all_invalid": (a[:300], b[:500], np.zeros(500, bool)),
        "single_valid": (a[:300], b[:500], np.eye(1, 500, 123, dtype=bool)[0]),
        "ragged": (a[:1001], b[:777], vb[:777]),
    }
    worst = 0.0
    for name, (qa, qb, qv) in cases.items():
        ta, tb = torch.from_numpy(qa).to(dev), torch.from_numpy(qb).to(dev)
        tv = torch.from_numpy(np.ascontiguousarray(qv)).to(dev)
        worst = max(worst, _k2_case(name, ta, tb, tv))
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    tv = torch.from_numpy(vb).to(dev)
    return dict(max_abs_err=worst, **_k2_timed("k2", ta, tb, tv))


def _k2_case(name, ta, tb, tv) -> float:
    """K2 once against its plain version: the -inf pattern equal, values
    within K2_ATOL, the index equal but where the plain top-2 is a near
    tie; returns the max |err|."""
    from cusift_tpu_torch.kernels import matcher as k2

    top, idx = k2.top2(ta, tb, tv)
    rtop, ridx = k2.top2_plain(ta, tb, tv)
    torch.cuda.synchronize()
    fin = torch.isfinite(rtop)
    if not torch.equal(fin, torch.isfinite(top)) or not torch.equal(
            top[~fin], rtop[~fin]):
        raise AssertionError(f"K2 {name}: -inf pattern differs")
    err = (top - rtop)[fin].abs().max().item() if fin.any() else 0.0
    gap = rtop[:, 0] - rtop[:, 1]
    bad = (idx != ridx) & ~(gap < K2_ATOL)
    if not err <= K2_ATOL or bad.any():
        raise AssertionError(f"K2 {name}: max |err| {err}, "
                             f"{int(bad.sum())} index mismatches")
    log("k2", case=name, shape=f"N{ta.shape[0]},M{tb.shape[0]}",
        valid_b=int(tv.sum()), max_abs_err=err)
    return err


def _k2_timed(tag, ta, tb, tv) -> dict:
    """K2's time, its plain version's and the library yardstick's on one
    input, with its launch plan and bound."""
    from cusift_tpu_torch.kernels import matcher as k2

    (n, d), m = ta.shape, tb.shape[0]
    top, idx = k2.top2(ta, tb, tv)
    ms = time_ms(lambda: k2.top2(ta, tb, tv), tag)
    plain_ms = time_ms(lambda: k2.top2_plain(ta, tb, tv), f"{tag} plain")
    # the library yardstick: one cuBLAS GEMM with the -inf column bias as
    # its epilogue input, then torch.topk
    bias = torch.where(tv, 0.0, -torch.inf)
    library_ms = time_ms(lambda: torch.topk(torch.addmm(bias, ta, tb.T), 2, dim=1),
                         f"{tag} library")
    plan = k2._launch_plan(n, m, d, k2._sm_count(ta.device.index))
    moved = nbytes(ta, tb, tv, top, idx)
    flops = 2.0 * n * m * d
    # bound_ms: the function's own 2*N*M*D at the tensor-core peak the
    # kernel uses; beside it the same work on the CUDA cores, and the
    # 3xTF32 algorithm's three products per multiply-add (not a bound)
    b = bound(moved, flops, TF32_FLOPS)
    log(tag, shape=f"N{n},M{m},D{d}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", faster_than_library=ms < library_ms,
        bound_ms=f"{b['bound_ms']:.4f}", splits=plan["splits"], blocks=plan["blocks"],
        card=json.dumps(smi_line()))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b,
                f32_bound_ms=bound(moved, flops)["bound_ms"],
                tf32x3_ms=bound(moved, 3 * flops, TF32_FLOPS)["bound_ms"],
                splits=plan["splits"])


def corner_error(h_est: np.ndarray, h_true: np.ndarray, h: int, w: int) -> float:
    corners = np.array([[10, 10, 1], [w - 10, 10, 1], [w - 10, h - 10, 1],
                        [10, h - 10, 1]], float).T

    def xfer(m):
        q = m @ corners
        return (q[:2] / q[2:]).T

    return float(np.abs(xfer(h_est) - xfer(h_true)).max())


def main_path(dev, h=480, w=640, sift_kw=BENCH_SIFT, num_hypotheses=1024,
              timed_runs=10) -> dict:
    """match_pair on the bench pair; returns the launch counts of one run."""
    from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
    from cusift_tpu_torch.data.synthetic import warped_pair
    from cusift_tpu_torch.models.twoview import match_pair

    cfg = SiftConfig(**sift_kw)
    rcfg = RansacConfig(num_hypotheses=num_hypotheses)
    ia, ib, h_true = warped_pair(h, w, seed=1, blobs=800, detail=0.25,
                                 detail_octaves=4)
    ta, tb = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)

    reset_counts()
    t0 = time.perf_counter()
    res = match_pair(ta, tb, cfg, MatchConfig(), rcfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()

    n_oct = cfg.num_octaves_for(h, w)
    others = sum(launches[k] for k in ("octave", "ori_hist", "desc_raw", "sep"))
    if launches["sampler"] < 2 * n_oct * 2 or launches["matcher"] < 1 or others:
        raise AssertionError(f"main path launches {launches}, expected >= "
                             f"{4 * n_oct} sampler, >= 1 matcher, no other")
    hom = res.homography
    feats_finite = all(bool(torch.isfinite(t).all()) for f in (res.feats_a, res.feats_b)
                       for t in (f.x, f.y, f.sigma, f.orientation, f.desc))
    if not feats_finite or res.feats_a.desc.shape != (cfg.total_kpts, 128):
        raise AssertionError("main path: features not finite or wrong shape")
    if not bool(hom.ok):
        raise AssertionError("main path: homography.ok is false")
    err = corner_error(hom.h.double().cpu().numpy(), h_true, h, w)
    if not err < MAX_CORNER_ERR:
        raise AssertionError(f"main path: corner transfer {err} px")

    times = wall_ms(lambda: match_pair(ta, tb, cfg, MatchConfig(), rcfg), timed_runs)
    kpts = int(res.feats_a.count) + int(res.feats_b.count)
    med = statistics.median(times)
    log("main", image=f"{h}x{w}", kpts_a=int(res.feats_a.count),
        kpts_b=int(res.feats_b.count), matches=int(res.matches.ok.sum()),
        inliers=int(hom.num_inliers), corner_err_px=f"{err:.4f}",
        first_run_s=f"{first_s:.3f}", pair_ms_median=f"{med:.3f}",
        pair_ms_min=f"{min(times):.3f}", pair_ms_max=f"{max(times):.3f}",
        kpts_per_s=f"{kpts / (med / 1e3):.0f}", launches=json.dumps(launches),
        card=json.dumps(smi_line()))
    return launches


def zero_probe(dev, h=480, w=640, sift_kw=BENCH_SIFT) -> None:
    from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
    from cusift_tpu_torch.models.twoview import match_pair

    z = torch.zeros((h, w), device=dev)
    res = match_pair(z, z, SiftConfig(**sift_kw), MatchConfig(),
                     RansacConfig(num_hypotheses=1024))
    n = int(res.feats_a.count)
    finite = bool(torch.isfinite(res.homography.h).all())
    if n != 0 or bool(res.homography.ok) or not finite:
        raise AssertionError(f"zero probe: kpts={n} ok={bool(res.homography.ok)} "
                             f"finite_h={finite}")
    log("zero", kpts=n, ok=False, finite_h=finite)


def bench_frames(dev, h=480, w=640, pairs=4):
    """bench.py's batch: warped_pair(seed=s) for s < pairs, stacked a, b, ...;
    returns the [2*pairs, h, w] frames and the pairs' true homographies."""
    from cusift_tpu_torch.data.synthetic import warped_pair

    frames, h_true = [], []
    for s in range(pairs):
        a, b, hom = warped_pair(h, w, seed=s, blobs=800, detail=0.25,
                                detail_octaves=4)
        frames += [a, b]
        h_true.append(hom)
    return torch.from_numpy(np.stack(frames)).to(dev), h_true


def _check_k3(name, x, cfg) -> tuple[float, float]:
    """K3 vs its plain version on base x: (max |err|, score mask agreement)."""
    from cusift_tpu_torch.kernels import octave as k3

    got = k3.fused_octave(x, cfg)
    ref = k3.fused_octave_plain(x, cfg)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got[:2], ref[:2]))
    fin, rfin = torch.isfinite(got[2]), torch.isfinite(ref[2])
    agree = (fin == rfin).float().mean().item()
    both = fin & rfin
    serr = (got[2] - ref[2])[both].abs().max().item() if both.any() else 0.0
    if not (err <= K3_ATOL and serr <= K3_ATOL and agree >= K3_MASK):
        raise AssertionError(f"K3 {name}: max |err| {err}, score err {serr}, "
                             f"score masks agree on {agree}")
    log("k3", case=name, shape=tuple(x.shape), max_abs_err=max(err, serr),
        mask_agree=f"{agree:.6f}", extrema=int(fin.sum()))
    return max(err, serr), agree


def check_octave(dev, imgs) -> dict:
    """K3 vs its plain version on the bench frames' octave-0 bases, batched
    and single, and batched against per-frame launches; then each octave
    the batch runs K3 on, checked and timed."""
    from cusift_tpu_torch import SiftConfig
    from cusift_tpu_torch.kernels import octave as k3
    from cusift_tpu_torch.ops.gaussian import downsample2, gaussian_taps
    from cusift_tpu_torch.ops.pyramid import initial_level

    cfg = SiftConfig(**BENCH_SIFT, **FUSED)
    base = initial_level(imgs, cfg).contiguous()            # [8, 960, 1280]
    errs = [_check_k3(name, x, cfg)
            for name, x in (("batch", base), ("single", base[3].contiguous()))]
    batched = k3.fused_octave(base, cfg)
    for i in range(base.shape[0]):
        one = k3.fused_octave(base[i].contiguous(), cfg)
        if not all(torch.equal(a, b[i]) for a, b in zip(one, batched)):
            raise AssertionError(f"K3: batched frame {i} differs from its own launch")
    plain_ms = time_ms(lambda: k3.fused_octave_plain(base, cfg), "k3 plain", iters=10)
    s = cfg.scales_per_octave
    taps = [gaussian_taps(sd).shape[0] for sd in k3.level_sigmas(cfg)]
    pad = max(taps) // 2 + 1
    # the octaves the batch runs K3 on: each base is level S of the one
    # before, decimated, down to the 64-px gate
    per_octave = []
    x = base
    while min(x.shape[-2:]) >= 64:
        b, h, w = x.shape
        if per_octave:
            errs.append(_check_k3(f"octave{len(per_octave)}", x, cfg))
        ms = time_ms(lambda x=x: k3.fused_octave(x, cfg), f"k3 {h}x{w}", iters=10)
        moved = 4 * b * ((h + 2 * pad) * (w + 2 * pad) + (3 * s + 2) * h * w)
        # two 1-D passes of FMAs per level, the DoG, and 3 ops per neighbour
        flops = b * h * w * (4 * sum(taps) + (s + 2) + 3 * 27 * s)
        per_octave.append(dict(shape=[b, h, w], ms=ms, **bound(moved, flops)))
        log("k3", shape=f"B{b}x{h}x{w}", ms=f"{ms:.4f}", ms_per_frame=f"{ms / b:.4f}",
            bound_ms=f"{per_octave[-1]['bound_ms']:.4f}", card=json.dumps(smi_line()))
        x = downsample2(k3.fused_octave(x, cfg)[0][:, s - 1])
    batch_ms = sum(o["ms"] for o in per_octave)
    batch_bound = sum(o["bound_ms"] for o in per_octave)
    log("k3", octaves=len(per_octave), batch_ms_sum=f"{batch_ms:.4f}",
        batch_bound_ms_sum=f"{batch_bound:.4f}", octave0_ms=f"{per_octave[0]['ms']:.4f}",
        plain_ms=f"{plain_ms:.4f}", batch_bit_equal=True)
    o0 = per_octave[0]
    return dict(max_abs_err=max(e for e, _ in errs), ms=o0["ms"], plain_ms=plain_ms,
                library_ms=None, mask_agree=min(a for _, a in errs), bound_ms=o0["bound_ms"], bound_by=o0["bound_by"],
                octaves=per_octave, batch_ms_sum=batch_ms, batch_bound_ms_sum=batch_bound)


def _rel_err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-12)).item()


# the batch's per-octave K4/K5 shapes: each frame's level stack and its
# slot budgets (config.py's octave_budgets, desc slots x 1.25)
OCTAVE_SHAPES = ((960, 1280), (480, 640), (240, 320), (120, 160), (60, 80))
ORI_SLOTS = (3072, 1536, 384, 96, 32)
DESC_SLOTS = (3840, 1920, 480, 120, 40)
BATCH_FRAMES = 8


def _hist_case(name, run, plain, rel_name):
    """One K4/K5 shape: kernel vs plain within HIST_REL, two runs identical,
    then the kernel's time.  Returns (out, ref, rel_err, ms)."""
    out, ref = run(), plain()
    err = _rel_err(out, ref)
    if not err <= HIST_REL:
        raise AssertionError(f"{name}: max |err| / max |{rel_name}| {err} > {HIST_REL}")
    if not torch.equal(out, run()):
        raise AssertionError(f"{name}: two runs differ")
    return out, ref, err, time_ms(run, name)


def _per_octave(tag, cases) -> dict:
    """Sum the per-octave times of one frame, x BATCH_FRAMES per batch."""
    frame_ms = sum(o["ms"] for o in cases)
    frame_bound = sum(o["bound_ms"] for o in cases)
    log(tag, octaves=len(cases), frame_ms_sum=f"{frame_ms:.4f}",
        batch_ms_sum=f"{BATCH_FRAMES * frame_ms:.4f}",
        batch_bound_ms_sum=f"{BATCH_FRAMES * frame_bound:.4f}",
        pct_of_bound=f"{100 * frame_bound / frame_ms:.1f}", card=json.dumps(smi_line()))
    return dict(octaves=cases, batch_ms_sum=BATCH_FRAMES * frame_ms,
                batch_bound_ms_sum=BATCH_FRAMES * frame_bound)


def check_ori_hist(dev, gen, L=3, S=144, nb=36) -> dict:
    """K4 vs its plain version at each octave shape the batch launches it
    on (octave 0 also timed against the plain version); samples include
    border and outside."""
    from cusift_tpu_torch.kernels import sampler as k

    cases, first = [], None
    for (H, W), N in zip(OCTAVE_SHAPES, ORI_SLOTS):
        gauss, lvl, ys, xs = _points(gen, dev, L, H, W, N, S)
        wv = torch.from_numpy(gen.uniform(0, 1, (N, S)).astype(np.float32)).to(dev)
        hist, ref, err, ms = _hist_case(
            f"k4 {H}x{W}", lambda: k.sample_ori_hist(gauss, lvl, ys, xs, wv, nb),
            lambda: k.sample_ori_hist_plain(gauss, lvl, ys, xs, wv, nb), "hist")
        abs_err = (hist - ref).abs().max().item()
        # per sample: the sampling, the polar form, and 2 bins of weight
        b = bound(nbytes(gauss, lvl, ys, xs, wv, hist),
                  N * S * (SAMPLE_FLOPS + POLAR_FLOPS + 2 * 6))
        plan = k._launch_plan(N, S, None, k._sm_count(dev.index))
        cases.append(dict(shape=[L, H, W, N, S], ms=ms, rel_err=err, max_abs_err=abs_err,
                          slots=plan["slots"], **b))
        log("k4", shape=f"L{L}x{H}x{W},N{N},S{S}", rel_err=err, max_abs_err=abs_err,
            ms=f"{ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}", slots=plan["slots"],
            blocks=plan["blocks"], threads=plan["threads"])
        if first is None:
            first = cases[0]
            plain_ms = time_ms(lambda: k.sample_ori_hist_plain(gauss, lvl, ys, xs, wv, nb),
                               "k4 plain")
            log("k4", shape=f"L{L}x{H}x{W},N{N},S{S}", plain_ms=f"{plain_ms:.4f}")
    return dict(max_abs_err=max(o["max_abs_err"] for o in cases),
                rel_err=max(o["rel_err"] for o in cases), ms=first["ms"],
                plain_ms=plain_ms, library_ms=None, bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], **_per_octave("k4", cases))


def check_desc_raw(dev, gen, L=3, S=144, nb=8, cells=16) -> dict:
    """K5 vs its plain version at each octave shape the batch launches it
    on, with the descriptor's own spatial weights (octave 0 also timed
    against the plain version)."""
    from cusift_tpu_torch.kernels import sampler as k
    from cusift_tpu_torch.ops.describe import _spatial_weights

    _, wsp, gw = (torch.from_numpy(a).to(dev) for a in _spatial_weights(12, 4))
    cases, first = [], None
    for (H, W), N in zip(OCTAVE_SHAPES, DESC_SLOTS):
        gauss, lvl, ys, xs = _points(gen, dev, L, H, W, N, S)
        wv = gw[None, :].expand(N, -1).contiguous()
        theta = torch.from_numpy(gen.uniform(0, 2 * np.pi, N).astype(np.float32)).to(dev)
        args = (gauss, lvl, ys, xs, theta, wv, wsp, nb)
        raw, ref, err, ms = _hist_case(f"k5 {H}x{W}", lambda: k.sample_desc_raw(*args),
                                       lambda: k.sample_desc_raw_plain(*args), "raw")
        abs_err = (raw - ref).abs().max().item()
        # per sample: the sampling, the polar form, 2 bins x 4 cells x 2 ops
        b = bound(nbytes(gauss, lvl, ys, xs, theta, wv, wsp, raw),
                  N * S * (SAMPLE_FLOPS + POLAR_FLOPS + 2 * 4 * 2))
        plan = k._launch_plan(N, S, cells, k._sm_count(dev.index))
        cases.append(dict(shape=[L, H, W, N, S], ms=ms, rel_err=err, max_abs_err=abs_err,
                          slots=plan["slots"], **b))
        log("k5", shape=f"L{L}x{H}x{W},N{N},S{S}", rel_err=err, max_abs_err=abs_err,
            ms=f"{ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}", slots=plan["slots"],
            blocks=plan["blocks"], threads=plan["threads"])
        if first is None:
            first = cases[0]
            plain_ms = time_ms(lambda: k.sample_desc_raw_plain(*args), "k5 plain")
            log("k5", shape=f"L{L}x{H}x{W},N{N},S{S}", plain_ms=f"{plain_ms:.4f}")
    return dict(max_abs_err=max(o["max_abs_err"] for o in cases),
                rel_err=max(o["rel_err"] for o in cases), ms=first["ms"],
                plain_ms=plain_ms, library_ms=None, bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], **_per_octave("k5", cases))


def _k6_case(tag, k, gauss, lvl, ys_rows, xs_cols) -> dict:
    """K6 once against its plain version (inb equal, atol K1_ATOL on
    in-image samples), timed beside the grid_sample yardstick; its bound
    counts the level pixels the expanded grid reads, as K1's does."""
    dx, dy, inb = k.sample_grad_patches_sep(gauss, lvl, ys_rows, xs_cols)
    rdx, rdy, rinb = k.sample_grad_patches_sep_plain(gauss, lvl, ys_rows, xs_cols)
    torch.cuda.synchronize()
    if not torch.equal(inb, rinb):
        raise AssertionError(f"{tag}: inb differs from the plain version")
    err = max((dx - rdx)[rinb].abs().max().item(), (dy - rdy)[rinb].abs().max().item())
    if not err <= K1_ATOL:
        raise AssertionError(f"{tag}: max |err| {err} > {K1_ATOL}")
    ms = time_ms(lambda: k.sample_grad_patches_sep(gauss, lvl, ys_rows, xs_cols), tag)
    ys, xs = expand_grid(ys_rows, xs_cols)
    b = bound(sample_bytes(gauss, lvl, ys, xs) + nbytes(lvl, ys_rows, xs_cols, dx, dy, inb),
              SAMPLE_FLOPS * ys.numel())
    (l, h, w), (n, gr), gc = gauss.shape, ys_rows.shape, xs_cols.shape[1]
    log(tag, shape=f"L{l}x{h}x{w},N{n},{gr}x{gc}", inb_frac=f"{rinb.float().mean():.4f}",
        max_abs_err=err, ms=f"{ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}",
        pct_of_bound=f"{100 * b['bound_ms'] / ms:.1f}", card=json.dumps(smi_line()))
    lib = library_yardstick(tag, gauss, lvl, ys, xs, rdx, rdy)
    log(tag, faster_than_library=ms <= lib["library_ms"])
    return dict(shape=[l, h, w, n, gr, gc], max_abs_err=err, ms=ms, **b, **lib)


def check_sep(dev, gen, L=3, G=12) -> dict:
    """K6 vs K1's plain version on the expanded grid: at random rows and
    columns (border and outside points included), then at the orientation
    grid of the separable path at each of its five octave shapes and slot
    budgets, which is where K6 runs (two launches of each per pair).  The
    JSON entry's times and bound are the orientation grid's octave 0."""
    from cusift_tpu_torch.kernels import sampler as k

    (H, W), N = OCTAVE_SHAPES[0], ORI_SLOTS[0]
    gauss, lvl, ys, xs = _points(gen, dev, L, H, W, N, G)
    rand = _k6_case("k6", k, gauss, lvl, ys, xs.flip(1).contiguous())
    octaves = []
    for (h, w), n in zip(OCTAVE_SHAPES, ORI_SLOTS):
        g = torch.from_numpy(gen.random((L, h, w), dtype=np.float32)).to(dev)
        inputs = (g, *orientation_rows(gen, dev, n, L, h, w))
        octaves.append(_k6_case(f"k6 orientation {h}x{w}", k, *inputs))
        if len(octaves) == 1:
            plain_ms = time_ms(lambda: k.sample_grad_patches_sep_plain(*inputs), "k6 plain")
            log("k6", shape=f"L{L}x{h}x{w},N{n},{G}x{G}", geometry="orientation",
                plain_ms=f"{plain_ms:.4f}")
    pair = {key: 2 * sum(o[key] for o in octaves) for key in ("ms", "bound_ms", "library_ms")}
    log("k6", geometry="orientation", pair_launches=2 * len(octaves),
        pair_ms_sum=f"{pair['ms']:.4f}", pair_bound_ms_sum=f"{pair['bound_ms']:.4f}",
        pair_library_ms_sum=f"{pair['library_ms']:.4f}",
        pct_of_bound=f"{100 * pair['bound_ms'] / pair['ms']:.1f}")
    o0 = octaves[0]
    return dict(max_abs_err=max(c["max_abs_err"] for c in [rand, *octaves]), ms=o0["ms"],
                plain_ms=plain_ms, library_ms=o0["library_ms"], bound_ms=o0["bound_ms"],
                bound_by=o0["bound_by"], orientation_octaves=octaves,
                pair_ms_sum=pair["ms"], pair_bound_ms_sum=pair["bound_ms"],
                pair_library_ms_sum=pair["library_ms"], random_points=rand)


def _covers(ref, got, i) -> tuple[bool, float]:
    """tests/test_extract.py's bound for frame i: valid counts within 15%,
    and >= 95% of ref's strong half within 1 px and 5% in scale of got."""
    vr, vg = ref.valid[i], got.valid[i]
    nr, ng = int(vr.sum()), int(vg.sum())
    resp = ref.response[i][vr].abs()
    strong = resp >= resp.median()
    xyr = torch.stack([ref.x[i], ref.y[i]], -1)[vr][strong]
    sgr = ref.sigma[i][vr][strong]
    xyg = torch.stack([got.x[i], got.y[i]], -1)[vg]
    sgg = got.sigma[i][vg]
    d = torch.cdist(xyr.double(), xyg.double())
    srel = (sgr.double()[:, None] / sgg.double()[None].clamp(min=1e-9)).log().abs()
    covered = ((d < 1.0) & (srel < 0.05)).any(1).double().mean().item()
    return abs(ng - nr) <= 0.15 * max(nr, 1) and covered >= 0.95, covered


def batched_fused_path(dev, imgs, h_true, timed_runs=10) -> dict:
    """bench.py's bstep on the port: extract_batch + 7 consecutive matches,
    fused configuration against the default one on the same frames."""
    from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
    from cusift_tpu_torch.models.sift import extract, extract_batch
    from cusift_tpu_torch.ops.match import match
    from cusift_tpu_torch.ops.ransac import find_homography

    fused_cfg = SiftConfig(**BENCH_SIFT, **FUSED)
    default_cfg = SiftConfig(**BENCH_SIFT)
    mcfg = MatchConfig()
    b, h, w = imgs.shape

    def bstep(cfg):
        f = extract_batch(imgs, cfg)
        ms = [match(f.desc[i], f.valid[i], f.desc[i + 1], f.valid[i + 1], mcfg)
              for i in range(b - 1)]
        return f, ms

    reset_counts()
    feats, matches = bstep(fused_cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    n_oct = fused_cfg.num_octaves_for(h, w)
    side = min(h, w) * (2 if fused_cfg.upscale else 1)
    n_big = sum(1 for o in range(n_oct) if side >> o >= 64)   # K3's size gate
    if not (launches["octave"] >= n_big and launches["ori_hist"] >= n_oct * b
            and launches["desc_raw"] >= n_oct * b and launches["matcher"] >= b - 1
            and launches["sampler"] == 0 and launches["sep"] == 0):
        raise AssertionError(f"batched fused path launches {launches}: expected "
                             f"K3 >= {n_big}, K4 and K5 >= {n_oct * b}, "
                             f"K2 >= {b - 1}, K1 = K6 = 0")
    ref, _ = bstep(default_cfg)
    # the batch's chain pyramid hands cuDNN [B, ...]; each frame must still
    # be extract's own features, slot by slot
    differ = [f"frame {i} {name}" for i in range(b)
              for name, got, one in zip(ref._fields, ref, extract(imgs[i], default_cfg))
              if not torch.equal(got[i], one)]
    log("batch", check="extract_batch == extract per frame", config="default",
        frames=b, fields=len(ref._fields), equal=not differ)
    if differ:
        raise AssertionError(f"extract_batch differs from extract: {differ[:8]}")
    coverage = []
    for i in range(b):
        ok, cov = _covers(ref, feats, i)
        coverage.append(cov)
        if not ok:
            raise AssertionError(f"frame {i}: fused features {int(feats.valid[i].sum())} "
                                 f"vs default {int(ref.valid[i].sum())}, strong "
                                 f"coverage {cov:.4f}")
    errs = []
    for p, hom_true in enumerate(h_true):
        m = matches[2 * p]
        j = m.idx.long()
        pa = torch.stack([feats.x[2 * p], feats.y[2 * p]], -1)
        pb = torch.stack([feats.x[2 * p + 1][j], feats.y[2 * p + 1][j]], -1)
        hom = find_homography(pa, pb, m.ok, RansacConfig(num_hypotheses=1024))
        err = corner_error(hom.h.double().cpu().numpy(), hom_true, h, w)
        if not (bool(hom.ok) and err < MAX_CORNER_ERR):
            raise AssertionError(f"pair {p}: ok={bool(hom.ok)} corner transfer {err} px")
        errs.append(err)

    timing = {}
    for name, cfg in (("fused", fused_cfg), ("default", default_cfg)):
        kpts = int(extract_batch(imgs, cfg).valid.sum())
        times = wall_ms(lambda: bstep(cfg), timed_runs)
        med = statistics.median(times)
        timing[name] = med
        log("batch", config=name, frames=b, kpts=kpts,
            batch_ms_median=f"{med:.3f}", batch_ms_min=f"{min(times):.3f}",
            batch_ms_max=f"{max(times):.3f}", ms_per_frame=f"{med / b:.3f}",
            kpts_per_s=f"{kpts / (med / 1e3):.0f}", card=json.dumps(smi_line()))
    log("batch", image=f"{b}x{h}x{w}", kpts=[int(v.sum()) for v in feats.valid],
        default_kpts=[int(v.sum()) for v in ref.valid],
        strong_coverage_min=f"{min(coverage):.4f}",
        corner_err_px=[f"{e:.4f}" for e in errs], launches=json.dumps(launches))
    return launches


def separable_path(dev, h=480, w=640, timed_runs=5) -> dict:
    """match_pair at the main path's configuration with sampler="separable"."""
    from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
    from cusift_tpu_torch.data.synthetic import warped_pair
    from cusift_tpu_torch.models.twoview import match_pair

    cfg = SiftConfig(**BENCH_SIFT, sampler="separable")
    rcfg = RansacConfig(num_hypotheses=1024)
    ia, ib, h_true = warped_pair(h, w, seed=1, blobs=800, detail=0.25,
                                 detail_octaves=4)
    ta, tb = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
    reset_counts()
    res = match_pair(ta, tb, cfg, MatchConfig(), rcfg)
    torch.cuda.synchronize()
    launches = read_counts()
    n = 2 * cfg.num_octaves_for(h, w)
    if (launches["sep"] < n or launches["sampler"] < n or launches["matcher"] < 1
            or launches["ori_hist"] or launches["desc_raw"] or launches["octave"]):
        raise AssertionError(f"separable path launches {launches}, expected "
                             f"K6 >= {n}, K1 >= {n}, K2 >= 1, no other")
    err = corner_error(res.homography.h.double().cpu().numpy(), h_true, h, w)
    if not (bool(res.homography.ok) and err < MAX_CORNER_ERR):
        raise AssertionError(f"separable path: corner transfer {err} px")
    times = wall_ms(lambda: match_pair(ta, tb, cfg, MatchConfig(), rcfg), timed_runs)
    log("separable", image=f"{h}x{w}", kpts_a=int(res.feats_a.count),
        kpts_b=int(res.feats_b.count), inliers=int(res.homography.num_inliers),
        corner_err_px=f"{err:.4f}", pair_ms_median=f"{statistics.median(times):.3f}",
        launches=json.dumps(launches))
    return launches


def rgbd_pair(dev, timed_runs=10) -> dict:
    """align_rgbd_pair on frames 0 and 2 of the 480x640 planar sequence."""
    from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
    from cusift_tpu_torch.models.twoview import align_rgbd_pair

    seq = planar_rgbd_sequence(8, 480, 640, seed=2, motion_scale=0.6)
    args = [torch.from_numpy(a).to(dev) for a in
            (seq.images[0], seq.depths[0], seq.images[2], seq.depths[2])]
    cfgs = (SiftConfig(**SLAM_SIFT), MatchConfig(), RansacConfig(inlier_thresh_3d=0.03))
    reset_counts()
    res = align_rgbd_pair(*args, seq.intr, *cfgs)
    torch.cuda.synchronize()
    launches = read_counts()
    n_oct = cfgs[0].num_octaves_for(*seq.images.shape[-2:])
    others = sum(launches[k] for k in ("octave", "ori_hist", "desc_raw", "sep"))
    if launches["sampler"] < 4 * n_oct or launches["matcher"] < 1 or others:
        raise AssertionError(f"rgbd pair launches {launches}, expected >= {4 * n_oct} "
                             f"sampler, >= 1 matcher, no other")
    r_true = seq.poses_r[2] @ seq.poses_r[0].T
    t_true = seq.poses_t[2] - r_true @ seq.poses_t[0]
    r_err = float(np.abs(res.rigid.r.cpu().numpy() - r_true).max())
    t_err = float(np.linalg.norm(res.rigid.t.cpu().numpy() - t_true))
    if not (bool(res.rigid.ok) and r_err < RIGID_R_ERR and t_err < RIGID_T_ERR):
        raise AssertionError(f"rgbd pair: ok={bool(res.rigid.ok)} R err {r_err}, "
                             f"t err {t_err} m")
    times = wall_ms(lambda: align_rgbd_pair(*args, seq.intr, *cfgs), timed_runs)
    log("rgbd", image="x".join(map(str, seq.images.shape[-2:])),
        kpts_a=int(res.feats_a.count), kpts_b=int(res.feats_b.count),
        matches=int(res.matches.ok.sum()), inliers=int(res.rigid.num_inliers),
        r_err=f"{r_err:.6f}", t_err_m=f"{t_err:.6f}",
        pair_ms_median=f"{statistics.median(times):.3f}", pair_ms_min=f"{min(times):.3f}",
        pair_ms_max=f"{max(times):.3f}", launches=json.dumps(launches),
        card=json.dumps(smi_line()))
    return launches


def _spread(xs) -> str:
    return (f"{statistics.median(xs):.3f} ({min(xs):.3f}-{max(xs):.3f})" if xs
            else "none")


@contextlib.contextmanager
def first_calls(module, name: str, key):
    """Within the block, keep clones of the tensor arguments of the first
    call of `module.name` for each value of key() (None keeps nothing);
    every call runs as before.  These are the inputs a path gives a kernel
    wrapper, to hold the kernel against its plain version on them."""
    calls, fn = {}, getattr(module, name)

    def wrapper(*args):
        k = key()
        if k is not None and k not in calls:
            calls[k] = tuple(t.clone() for t in args)
        return fn(*args)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def slam_setup(n_frames: int = SLAM_FRAMES, scene: dict = SLAM_SCENE):
    """Phase 14's orbit (`scene`: planar_rgbd_sequence's keywords) and a
    builder of its Slam: (seq, frames, build), build(dev, dist_ba=False,
    **slam_cfg overrides)."""
    from cusift_tpu_torch import RansacConfig, SiftConfig, SlamConfig
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
    from cusift_tpu_torch.models.slam import Slam

    seq = planar_rgbd_sequence(n_frames, 480, 640, **scene)

    def build(dev, dist_ba=False, **kw):
        return Slam(seq.intr, sift_cfg=SiftConfig(**SLAM_SIFT),
                    ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                    slam_cfg=SlamConfig(**SLAM_CFG, **kw), dist_ba=dist_ba, device=dev)

    return seq, list(zip(seq.images, seq.depths)), build


def observe(slam) -> dict:
    """Time one Slam's frames and fused keyframe events through its
    on_metric and on_event hooks: the host clock at each committed frame,
    each event step's device span (CUDA events around its enqueue) and its
    K1/K2 launches, and each applied event's record."""
    from cusift_tpu_torch.kernels import matcher, sampler

    st = dict(frame_end=[], events=[], applied=[])

    def on_event(stage, x):
        if stage == "applied":
            st["applied"].append(x)
            return
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        if stage == "dispatch":
            st["events"].append(dict(marks=[mark], k1=sampler.launches, k2=matcher.launches))
        else:
            e = st["events"][-1]
            e["marks"].append(mark)
            e["k1"] = sampler.launches - e["k1"]
            e["k2"] = matcher.launches - e["k2"]

    slam.on_metric = lambda rec: st["frame_end"].append(time.perf_counter())
    slam.on_event = on_event
    return st


def event_stats(st) -> dict:
    """ms per keyframe event (device span + apply) and the events' K1/K2
    launches, from `observe`'s record."""
    dev_ms = [e["marks"][0].elapsed_time(e["marks"][1]) for e in st["events"]]
    apply_ms = [a["apply_ms"] for a in st["applied"]]
    return dict(n=len(st["events"]), ms=[d + a for d, a in zip(dev_ms, apply_ms)],
                device_ms=dev_ms, apply_ms=apply_ms,
                k1=sum(e["k1"] for e in st["events"]), k2=sum(e["k2"] for e in st["events"]))


def slam_path(dev) -> tuple[dict, dict, dict]:
    """Slam.run on the 48-frame orbit (BASELINE configs[3]), then a short
    pass with an 8-keyframe ring, where eviction fires.  Returns the
    timed run's launch counts, the K1/K2 inputs the warm-up gave them
    (frame 0's K1 calls, K2's first tracking and first keyframe-event
    call) and the timed run's frames/s and keyframes."""
    from cusift_tpu_torch import PoseGraphConfig, SiftConfig
    from cusift_tpu_torch.kernels import matcher, sampler

    seq, frames, build = slam_setup()
    n_k1 = 2 * SiftConfig(**SLAM_SIFT).num_octaves_for(*seq.images.shape[-2:])

    # set-up, apart from the timed run: the first window BA, retrieval and
    # dense graph solve load their CUDA libraries and modules
    t0 = time.perf_counter()
    warm = build(dev)
    in_event = [False]
    warm.on_event = lambda stage, _: in_event.__setitem__(0, stage == "dispatch")
    reset_counts()
    with first_calls(sampler, "sample_grad_patches",
                     lambda: sampler.launches if sampler.launches < n_k1 else None) as k1_in, \
            first_calls(matcher, "top2",
                        lambda: "event" if in_event[0] else "tracking") as k2_in:
        warm.run(iter(frames[:WARMUP_FRAMES]))
    torch.cuda.synchronize()
    log("slam", warmup_frames=WARMUP_FRAMES, warmup_s=f"{time.perf_counter() - t0:.3f}")

    slam = build(dev)
    st = observe(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    recs = slam.run(iter(frames))
    t_end = time.perf_counter()
    launches = read_counts()
    s = slam.state
    tracked = sum(1 for r in recs if r.get("tracked", True))
    ba = [a for a in st["applied"] if a["window"]]
    ba_ok = [a for a in ba if a["ba_cost"][1] <= a["ba_cost"][0] and a["ba_cost"][0] > 0]
    ate = slam.ate(seq.poses_r, seq.poses_t)
    others = sum(launches[k] for k in ("octave", "ori_hist", "desc_raw", "sep"))
    if (len(recs) != SLAM_FRAMES or tracked != SLAM_FRAMES or s.n_kf_total < 10
            or not ba_ok or s.n_closures < 1 or not ate < MAX_ATE):
        raise AssertionError(f"slam: frames {len(recs)}, tracked {tracked}, keyframes "
                             f"{s.n_kf_total}, window BAs {len(ba)} ({len(ba_ok)} not "
                             f"worse), closures {s.n_closures}, ATE {ate}")
    if launches["sampler"] == 0 or launches["matcher"] == 0 or others:
        raise AssertionError(f"slam launches {launches}: expected K1 and K2, no other")
    ev = event_stats(st)
    ev_k1, ev_k2, n_events = ev["k1"], ev["k2"], ev["n"]
    closing = [a["apply_ms"] for a in st["applied"] if a["accept"]]
    marks = st["frame_end"]
    frame_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    fps = (SLAM_FRAMES - 1) / (t_end - marks[0])
    n_steps = SLAM_FRAMES - 1            # every frame after the first tracks
    stats = dict(fps=fps, keyframes=s.n_kf_total, trajectory=slam.trajectory())
    log("slam", image="x".join(map(str, seq.images.shape[-2:])), frames=SLAM_FRAMES,
        tracked=tracked, keyframes=s.n_kf_total, closures=s.n_closures, window_bas=len(ba),
        window_bas_not_worse=len(ba_ok), ate_m=f"{ate:.6f}",
        kpts_median=statistics.median(r["kpts"] for r in recs),
        kpts_min=min(r["kpts"] for r in recs), kpts_budget=SiftConfig(**SLAM_SIFT).total_kpts,
        inliers_median=statistics.median(r["inliers"] for r in recs[1:]),
        fps_after_first=f"{fps:.3f}", frame_ms=_spread(frame_ms),
        events=n_events, event_ms=_spread(ev["ms"]), event_device_ms=_spread(ev["device_ms"]),
        event_apply_ms=_spread(ev["apply_ms"]), closing_apply_ms=_spread(closing),
        k1_per_frame=f"{(launches['sampler'] - ev_k1) / SLAM_FRAMES:.2f}",
        k2_per_tracking_step=f"{(launches['matcher'] - ev_k2) / n_steps:.2f}",
        k1_per_event=f"{ev_k1 / max(n_events, 1):.2f}",
        k2_per_event=f"{ev_k2 / max(n_events, 1):.2f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f}",
        launches=json.dumps(launches), card=json.dumps(smi_line()))

    # the final map's graph solve with each solver, as the split path
    # (pg_cfg, "cg" by default) and the fused event ("dense") run it
    solves = {solver: wall_ms(lambda c=PoseGraphConfig(solver=solver): slam._optimize_graph(c),
                              3, warmup=1) for solver in ("dense", "cg")}
    log("slam", graph_nodes=s.n_kf, graph_edges=len(s.edge_i),
        pg_dense_ms=_spread(solves["dense"]), pg_cg_ms=_spread(solves["cg"]))

    small = build(dev, max_keyframes=8)
    recs = small.run(iter(frames[:20]))
    tracked = sum(1 for r in recs if r.get("tracked", True))
    evicted = small.state.n_kf_total - small.state.n_kf
    ate = small.ate(seq.poses_r[:20], seq.poses_t[:20])
    if tracked != 20 or small.state.n_kf != 8 or evicted < 1 or not np.isfinite(ate):
        raise AssertionError(f"slam eviction pass: tracked {tracked}/20, ring "
                             f"{small.state.n_kf}, evicted {evicted}, ATE {ate}")
    log("slam", eviction_pass_frames=20, tracked=tracked, ring=small.state.n_kf,
        keyframes=small.state.n_kf_total, evicted=evicted,
        frozen_frames=sum(1 for r in small.state.traj_ref if r < 0), ate_m=f"{ate:.6f}")
    if len(k1_in) != n_k1 or set(k2_in) != {"tracking", "event"}:
        raise AssertionError(f"slam warm-up kept {len(k1_in)} K1 inputs of {n_k1}, "
                             f"K2 inputs {sorted(k2_in)}")
    return launches, dict(k1=[k1_in[i] for i in range(n_k1)], k2=k2_in), stats


def count_chunk_fetches(slam) -> dict:
    """Count a chunked run's steps and the commits that had to fetch their
    own row (a device tensor handed to `_commit`), through instance
    attributes that call the class's methods."""
    seen = dict(steps=0, commit_fetches=0, commits=0)
    step, commit = slam._chunk_sense_step, slam._commit

    def chunk_step(*args):
        seen["steps"] += 1
        return step(*args)

    def counted_commit(feats, pts, packed, ref, index=None):
        seen["commits"] += 1
        seen["commit_fetches"] += isinstance(packed, torch.Tensor)
        return commit(feats, pts, packed, ref, index=index)

    slam._chunk_sense_step, slam._commit = chunk_step, counted_commit
    return seen


def chunked_slam_path(dev, chunk1: dict) -> dict:
    """Phase 14's orbit at chunk 8: a chunk step's rows against sequential
    steps bit for bit, then Slam.run(chunk=8) timed beside phase 14's
    chunk-1 run (`chunk1`: its frames/s and keyframes)."""
    from cusift_tpu_torch import SiftConfig
    from cusift_tpu_torch.models.slam import _chunk_step, _frame_step

    seq, frames, build = slam_setup()
    cfg = SiftConfig(**SLAM_SIFT)
    slam = build(dev)
    slam.process_frame(*frames[0])
    _, kd, kv, kp = slam._ref_cache
    chunk = torch.from_numpy(np.stack([np.stack(f) for f in frames[1:CHUNK + 1]])).to(dev)
    ctr = slam._key_ctr
    _, _, rows = _chunk_step(chunk, slam.intr, kd, kv, kp, cfg, slam.match_cfg,
                             slam.ransac_cfg, slam._next_keys(CHUNK))
    slam._key_ctr = ctr
    seq_rows = torch.stack([
        _frame_step(chunk[i, 0], chunk[i, 1], slam.intr, kd, kv, kp, cfg, slam.match_cfg,
                    slam.ransac_cfg, slam._next_key())[2] for i in range(CHUNK)])
    diff = (rows - seq_rows).abs().max().item()
    log("chunk", check="chunk rows == sequential rows", frames=CHUNK,
        bit_equal=torch.equal(rows, seq_rows), max_abs_diff=diff,
        inliers=[int(v) for v in rows[:, 0].tolist()])
    if not torch.equal(rows, seq_rows):
        raise AssertionError(f"chunk rows differ from sequential rows by {diff}")

    t0 = time.perf_counter()
    build(dev).run(iter(frames[:WARMUP_FRAMES]), chunk=CHUNK)
    torch.cuda.synchronize()
    log("chunk", warmup_frames=WARMUP_FRAMES, warmup_s=f"{time.perf_counter() - t0:.3f}")

    slam = build(dev)
    st = observe(slam)
    fetch = count_chunk_fetches(slam)
    torch.cuda.synchronize()
    reset_counts()
    recs = slam.run(iter(frames), chunk=CHUNK)
    t_end = time.perf_counter()
    launches = read_counts()
    s = slam.state
    tracked = sum(1 for r in recs if r.get("tracked", True))
    ate = slam.ate(seq.poses_r, seq.poses_t)
    steps = -(-(SLAM_FRAMES - 1) // CHUNK)
    if (len(recs) != SLAM_FRAMES or tracked != SLAM_FRAMES or not ate < MAX_ATE
            or s.n_kf_total < 10 or not s.n_kf_total < 2 * chunk1["keyframes"]
            or fetch["steps"] != steps or fetch["commit_fetches"]
            or fetch["commits"] != SLAM_FRAMES - 1):
        raise AssertionError(f"chunked slam: frames {len(recs)}, tracked {tracked}, ATE {ate}, "
                             f"keyframes {s.n_kf_total} (chunk 1: {chunk1['keyframes']}), "
                             f"fetches {fetch} for {steps} steps")
    ev = event_stats(st)
    fps = (SLAM_FRAMES - 1) / (t_end - st["frame_end"][0])
    log("chunk", image="x".join(map(str, seq.images.shape[-2:])), frames=SLAM_FRAMES,
        chunk=CHUNK, steps=fetch["steps"], row_fetches=fetch["steps"], tracked=tracked,
        keyframes=s.n_kf_total, chunk1_keyframes=chunk1["keyframes"],
        closures=s.n_closures, ate_m=f"{ate:.6f}", fps_after_first=f"{fps:.3f}",
        chunk1_fps=f"{chunk1['fps']:.3f}", chunk8_over_chunk1=f"{fps / chunk1['fps']:.3f}",
        events=ev["n"], event_ms=_spread(ev["ms"]),
        k1_per_frame=f"{(launches['sampler'] - ev['k1']) / SLAM_FRAMES:.2f}",
        k2_per_tracking_step=f"{(launches['matcher'] - ev['k2']) / (SLAM_FRAMES - 1):.2f}",
        launches=json.dumps(launches), card=json.dumps(smi_line()))
    return launches


def stereo_scene():
    """The north-star stereo scene, cut to STEREO_FRAMES."""
    from cusift_tpu_torch.data.synthetic import two_plane_stereo_sequence

    t0 = time.perf_counter()
    seq = two_plane_stereo_sequence(STEREO_FRAMES, 480, 640, **STEREO_SCENE)
    log("stereo", scene_frames=STEREO_FRAMES, render_s=f"{time.perf_counter() - t0:.3f}")
    return seq


def stereo_pair(dev, seq, timed_runs=10) -> dict:
    """_extract_stereo_points on frame 0 of the stereo scene."""
    from cusift_tpu_torch import MatchConfig, SiftConfig
    from cusift_tpu_torch.models.sift import extract
    from cusift_tpu_torch.models.stereo import _extract_stereo_points

    cfg = SiftConfig(**STEREO_SIFT)
    il, ir, intr = (torch.from_numpy(a).to(dev) for a in
                    (seq.images_l[0], seq.images_r[0], seq.intr))
    baseline = torch.tensor(np.float32(seq.baseline), device=dev)
    args = (il, ir, intr, baseline, cfg, MatchConfig())
    reset_counts()
    fl, pts, dok = _extract_stereo_points(*args)
    torch.cuda.synchronize()
    launches = read_counts()
    h, w = seq.images_l.shape[-2:]
    n_k1 = 2 * 2 * cfg.num_octaves_for(h, w)
    others = sum(launches[k] for k in ("octave", "ori_hist", "desc_raw", "sep"))
    if launches["sampler"] != n_k1 or launches["matcher"] != 1 or others:
        raise AssertionError(f"stereo pair launches {launches}: expected K1 {n_k1}, K2 1")
    ok = dok.cpu().numpy()
    xi = np.clip(np.round(fl.x.cpu().numpy()).astype(int), 0, w - 1)
    yi = np.clip(np.round(fl.y.cpu().numpy()).astype(int), 0, h - 1)
    gt = seq.depths[0][yi, xi]
    have = ok & (gt > 0.05)
    rel = np.abs(pts[:, 2].cpu().numpy()[have] - gt[have]) / gt[have]
    med = float(np.median(rel)) if have.any() else float("inf")
    if not (ok.sum() >= STEREO_MIN_MATCHES and med < STEREO_DEPTH_REL):
        raise AssertionError(f"stereo pair: {int(ok.sum())} admissible matches, median "
                             f"relative depth error {med}")
    times = wall_ms(lambda: _extract_stereo_points(*args), timed_runs)
    log("stereo", image=f"{h}x{w}", kpts_left=int(fl.valid.sum()),
        kpts_right=int(extract(ir, cfg).valid.sum()), admissible=int(ok.sum()),
        depth_rel_err_median=f"{med:.6f}", pair_ms=_spread(times),
        launches=json.dumps(launches), card=json.dumps(smi_line()))
    return launches


def stereo_slam_run(dev, seq, chunk: int, n_frames: int) -> dict:
    """StereoSlam.run over the first n_frames of the scene at `chunk`, after
    an untimed 16-frame warm-up; checks the soak's bounds."""
    from cusift_tpu_torch import SiftConfig, SlamConfig
    from cusift_tpu_torch.data.evaluation import ate_rmse, kitti_drift, trajectory_path_length
    from cusift_tpu_torch.models.stereo import StereoSlam

    def build():
        return StereoSlam(seq.intr, seq.baseline, sift_cfg=SiftConfig(**STEREO_SIFT),
                          slam_cfg=SlamConfig(**STEREO_SLAM_CFG), device=dev)

    pairs = list(zip(seq.images_l[:n_frames], seq.images_r[:n_frames]))
    t0 = time.perf_counter()
    build().run(iter(pairs[:WARMUP_FRAMES]), chunk=chunk)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    slam = build()
    st = observe(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    recs = slam.run(iter(pairs), chunk=chunk)
    t_end = time.perf_counter()
    launches = read_counts()
    s = slam.state
    tracked = sum(1 for r in recs if r.get("tracked", True))
    gt_r, gt_t = seq.poses_r[:n_frames], seq.poses_t[:n_frames]
    er, et = slam.trajectory()
    path = float(trajectory_path_length(gt_r, gt_t)[-1])
    ate = ate_rmse(er, et, gt_r, gt_t)
    drift, rot_drift = kitti_drift(er, et, gt_r, gt_t, lengths=(0.25 * path, 0.5 * path),
                                   step=2)
    min_tracked = n_frames - (STEREO_FRAMES - STEREO_MIN_TRACKED)
    others = sum(launches[k] for k in ("octave", "ori_hist", "desc_raw", "sep"))
    if (len(recs) != n_frames or tracked < min_tracked or not ate < STEREO_ATE_OF_PATH * path
            or not drift < STEREO_MAX_DRIFT or others or not launches["sampler"]
            or not launches["matcher"]):
        raise AssertionError(f"stereo slam chunk {chunk}: frames {len(recs)}, tracked "
                             f"{tracked}, ATE {ate} of path {path}, drift {drift} %, "
                             f"launches {launches}")
    ev = event_stats(st)
    fps = (n_frames - 1) / (t_end - st["frame_end"][0])
    out = dict(chunk=chunk, frames=n_frames, fps=fps, tracked=tracked,
               keyframes=s.n_kf_total, closures=s.n_closures,
               evicted=s.n_kf_total - s.n_kf, ate_m=ate, path_m=path, drift_pct=drift,
               kpts_median=statistics.median(r["kpts"] for r in recs),
               k1_per_frame=(launches["sampler"] - ev["k1"]) / n_frames,
               k2_per_frame=(launches["matcher"] - ev["k2"]) / n_frames,
               launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log("stereo_slam", image="x".join(map(str, seq.images_l.shape[-2:])), chunk=chunk,
        frames=n_frames, warmup_s=f"{warmup_s:.3f}", tracked=tracked,
        keyframes=s.n_kf_total, closures=s.n_closures, evicted=out["evicted"],
        ring=s.n_kf, ate_m=f"{ate:.6f}", path_m=f"{path:.4f}",
        ate_of_path=f"{ate / path:.5f}", drift_pct=f"{drift:.4f}",
        rot_drift_deg_per_m=f"{rot_drift:.4f}", kpts_median=out["kpts_median"],
        kpts_min=min(r["kpts"] for r in recs), fps_with_ba=f"{fps:.3f}",
        events=ev["n"], event_ms=_spread(ev["ms"]),
        k1_per_frame=f"{out['k1_per_frame']:.2f}", k2_per_frame=f"{out['k2_per_frame']:.2f}",
        k1_per_event=f"{ev['k1'] / max(ev['n'], 1):.2f}",
        k2_per_event=f"{ev['k2'] / max(ev['n'], 1):.2f}",
        peak_mem_gb=f"{out['peak_mem_gb']:.3f}", launches=json.dumps(launches),
        card=json.dumps(smi_line()))
    return out


def stereo_slam_path(dev, seq) -> dict:
    """Phase 18: the stereo scene at chunk 1 and at chunk 8."""
    runs = {c: stereo_slam_run(dev, seq, c, n) for c, n in ((1, STEREO_FRAMES),
                                                           (CHUNK, STEREO_CHUNK_FRAMES))}
    log("stereo_slam", chunk8_over_chunk1_fps=f"{runs[CHUNK]['fps'] / runs[1]['fps']:.3f}",
        chunk8_frames=STEREO_CHUNK_FRAMES)
    return runs


@contextlib.contextmanager
def first_segment_calls(tag: str, limit: int = 4, live: bool = False):
    """Within the block, keep the first call of `segment.segment_sum` of
    each (row shape, segment count), up to `limit`, as (x clone, plan)
    under "tag i": the inputs a path gives the segment-sum kernel.  With
    `live`, a call whose x is all zero is replaced by the next one of its
    kind (a host read a call until one is not)."""
    from cusift_tpu_torch.kernels import segment

    calls, names, done, fn = {}, {}, set(), segment.segment_sum

    def wrapper(x, p):
        key = (tuple(x.shape[1:]), p.n)
        if key not in done and (key in names or len(names) < limit):
            names.setdefault(key, f"{tag} {len(names)}")
            calls[names[key]] = (x.clone(), p)
            if not live or bool(x.any()):
                done.add(key)
        return fn(x, p)

    segment.segment_sum = wrapper
    try:
        yield calls
    finally:
        segment.segment_sum = fn


def check_sampler_slam(dev, calls, path: str = "slam") -> dict:
    """K1 at the inputs one frame's extraction on the SLAM path (or the
    VO path, `path="vo"`) gave it (480x640 levels, no upscale, 1024 slots
    an octave; orientation and descriptor geometry in each octave): each
    call against its plain version and the grid_sample yardstick, timed,
    and summed per frame."""
    from cusift_tpu_torch.kernels import sampler as k1

    cases = []
    for i, (gauss, lvl, ys, xs) in enumerate(calls):
        tag = f"k1 {path} {i}"
        case = _k1_case(tag, k1, gauss, lvl, ys, xs)
        ms = time_ms(lambda: k1.sample_grad_patches(gauss, lvl, ys, xs), tag)
        plain_ms = time_ms(lambda: k1.sample_grad_patches_plain(gauss, lvl, ys, xs),
                           f"{tag} plain")
        lib = library_yardstick(tag, gauss, lvl, ys, xs, *case["plain"])
        (l, h, w), (n, smp) = gauss.shape, ys.shape
        b = case["bound"]
        cases.append(dict(shape=[l, h, w, n, smp], max_abs_err=case["max_abs_err"], ms=ms,
                          plain_ms=plain_ms, library_ms=lib["library_ms"], **b))
        log("k1", path=path, call=i, shape=f"L{l}x{h}x{w},N{n},S{smp}",
            inb_frac=f"{case['plain'][2].float().mean():.4f}", max_abs_err=case["max_abs_err"],
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib['library_ms']:.4f}",
            bound_ms=f"{b['bound_ms']:.4f}", pct_of_bound=f"{100 * b['bound_ms'] / ms:.1f}")
    frame = {key: sum(c[key] for c in cases)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log("k1", path=path, calls_per_frame=len(cases), frame_ms_sum=f"{frame['ms']:.4f}",
        frame_plain_ms_sum=f"{frame['plain_ms']:.4f}",
        frame_library_ms_sum=f"{frame['library_ms']:.4f}",
        frame_bound_ms_sum=f"{frame['bound_ms']:.4f}", card=json.dumps(smi_line()))
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases), calls=cases,
                **{f"frame_{k}_sum": v for k, v in frame.items()})


def check_matcher_slam(dev, calls) -> dict:
    """K2 at the inputs the SLAM path gave it (2048 x 2048, the frames'
    own valid masks): its first tracking call and its first call in a
    keyframe event, each against its plain version and timed."""
    out = {}
    for kind in ("tracking", "event"):
        ta, tb, tv = calls[kind]
        err = _k2_case(f"slam {kind}", ta, tb, tv)
        out[kind] = dict(max_abs_err=err, valid_b=int(tv.sum()),
                         **_k2_timed(f"k2 slam {kind}", ta, tb, tv))
    return dict(max_abs_err=max(o["max_abs_err"] for o in out.values()), **out)



# ---------- phases 19-22: monocular VO and SfM (BASELINE configs[4], [2]) ----------

def _ang_deg(a, b) -> float:
    return float(np.degrees(np.arccos(np.clip(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)),
                                              -1.0, 1.0))))


def _rel_gt(seq_r, seq_t, a, b):
    """Ground-truth motion x_b = R x_a + t between frames a and b."""
    r = seq_r[b] @ seq_r[a].T
    return r, seq_t[b] - r @ seq_t[a]


def sim3_drift_graph():
    """tests/test_sim3.py's constructed scale-drift loop (16 nodes, step
    translations scaled by e^(0.03 k), one loop edge measuring the epoch
    scale), built with the port's se3_exp: (gt_r, gt_t, graph arrays)."""
    from cusift_tpu_torch.optim.lie import se3_exp

    n, gamma = 16, 0.03
    gt_r, gt_t = [np.eye(3)], [np.zeros(3)]
    for k in range(1, n):
        s = k / (n - 1)
        xi = torch.tensor([0.6 * np.sin(2 * np.pi * s), 0.1 * np.sin(4 * np.pi * s),
                           0.5 * np.sin(2 * np.pi * s + 1.1), 0.05 * np.sin(2 * np.pi * s),
                           0.30 * np.sin(2 * np.pi * s), 0.05 * np.sin(4 * np.pi * s)],
                          dtype=torch.float64)
        r, t = se3_exp(xi)
        gt_r.append(r.numpy())
        gt_t.append(t.numpy())
    gt_r, gt_t = np.stack(gt_r), np.stack(gt_t)
    ei, ej, mr, mt, ms = [], [], [], [], []
    est_r, est_t = [gt_r[0]], [gt_t[0]]
    for k in range(n - 1):
        r_rel, t_rel = _rel_gt(gt_r, gt_t, k + 1, k)
        d = np.exp(gamma * k)
        ei.append(k), ej.append(k + 1), mr.append(r_rel), mt.append(t_rel * d), ms.append(1.0)
        est_r.append(r_rel.T @ est_r[-1])
        est_t.append(r_rel.T @ (est_t[-1] - t_rel * d))
    r_rel, t_rel = _rel_gt(gt_r, gt_t, n - 1, 0)
    ei.append(0), ej.append(n - 1), mr.append(r_rel), mt.append(t_rel)
    ms.append(np.exp(-gamma * (n - 2)))
    f32 = np.float32
    return gt_r, gt_t, dict(
        poses_r=np.stack(est_r).astype(f32), poses_t=np.stack(est_t).astype(f32),
        poses_s=np.ones(n, f32), edge_i=np.array(ei, np.int64), edge_j=np.array(ej, np.int64),
        meas_r=np.stack(mr).astype(f32), meas_t=np.stack(mt).astype(f32),
        meas_s=np.array(ms, f32), weight=np.ones(len(ei), f32))


def _centres(r, t):
    return -np.einsum("nji,nj->ni", r, t)


def check_sim3(dev) -> dict:
    """The Sim(3) LM on the card on the drift loop, held to
    tests/test_sim3.py's three bars, and timed (5 solves after a warm-up)."""
    from cusift_tpu_torch import PoseGraphConfig
    from cusift_tpu_torch.optim.sim3graph import Sim3Graph, optimize

    gt_r, gt_t, a = sim3_drift_graph()
    g = Sim3Graph(**{k: torch.from_numpy(v).to(dev) for k, v in a.items()})
    cfg = PoseGraphConfig(max_iters=30, cg_iters=60)
    res = optimize(g, cfg)
    s = res.poses_s.cpu().numpy()
    err0 = np.linalg.norm(_centres(a["poses_r"], a["poses_t"]) - _centres(gt_r, gt_t), axis=1)
    err1 = np.linalg.norm(_centres(res.poses_r.cpu().numpy(), res.poses_t.cpu().numpy() / s[:, None])
                          - _centres(gt_r, gt_t), axis=1)
    spread = float(np.std(np.log(s / np.exp(0.03 * np.arange(16)))[1:]))
    c, c0 = float(res.cost), float(res.initial_cost)
    if not (c < 0.05 * c0 and err1.max() < 0.25 * err0.max() and spread < 0.15):
        raise AssertionError(f"sim3 on the card: cost {c} of {c0}, centre error {err1.max()} "
                             f"vs {err0.max()}, scale spread {spread}")
    times = wall_ms(lambda: optimize(g, cfg).cost.item(), 5, warmup=1)
    log("mono_pair", sim3_cost=f"{c:.6g}", sim3_initial_cost=f"{c0:.6g}",
        sim3_centre_err=f"{err1.max():.5f}", sim3_raw_centre_err=f"{err0.max():.5f}",
        sim3_scale_spread=f"{spread:.5f}", sim3_ms=_spread(times), sim3_iters=cfg.max_iters,
        sim3_cg_iters=cfg.cg_iters, card=json.dumps(smi_line()))
    return dict(cost=c, initial_cost=c0, ms=statistics.median(times))


MONO_PAIR_R_ERR = 0.02       # max |R - R_gt| of a pair (tests/test_odometry.py:50)
MONO_PAIR_MIN_INLIERS = 60   # tests/test_odometry.py:46
MONO_PNP_T_REL = 0.2         # PnP t against the chain-scaled ground truth, relative


def mono_pair(dev, seq, timed_runs=10) -> dict:
    """Phase 19: frames 0->1 and 1->2 of the VO scene through `pair_step`
    (K1 10, K2 1 a pair), `find_pnp` on the second pair's chain-scaled
    points, and the Sim(3) graph on the card."""
    from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
    from cusift_tpu_torch.models.odometry import _pair_core, pair_step
    from cusift_tpu_torch.ops.ransac import step_generators
    from cusift_tpu_torch.models.sift import extract
    from cusift_tpu_torch.ops.pnp import find_pnp

    cfg, mcfg, rcfg = SiftConfig(**STEREO_SIFT), MatchConfig(), RansacConfig()
    imgs = [torch.from_numpy(seq.images_l[i]).to(dev) for i in range(3)]
    intr = torch.from_numpy(seq.intr).to(dev)
    fa = extract(imgs[0], cfg)
    depth, scale = torch.zeros(cfg.total_kpts, device=dev), torch.ones((), device=dev)
    out, rows = [], []
    for i in (1, 2):
        reset_counts()
        res, row = pair_step(fa.desc, fa.valid, torch.stack([fa.x, fa.y], -1), depth, imgs[i],
                             intr, scale, cfg, mcfg, rcfg, step_generators(dev, 0, i, 2))
        launches = read_counts()
        out.append((res, row, launches, (fa, depth, scale)))
        fa, depth, scale = res.feats, res.depth, res.scale
    n_k1 = 2 * cfg.num_octaves_for(*seq.images_l.shape[-2:])
    r_err, t_deg = [], []
    for i, (res, row, launches, _) in enumerate(out):
        r_gt, t_gt = _rel_gt(seq.poses_r, seq.poses_t, i, i + 1)
        r_err.append(float(np.abs(row[:9].reshape(3, 3) - r_gt).max()))
        t_deg.append(_ang_deg(row[9:12], t_gt))
        if (row[15] < 0.5 or row[13] < MONO_PAIR_MIN_INLIERS or r_err[-1] > MONO_PAIR_R_ERR
                or launches["sampler"] != n_k1 or launches["matcher"] != 1):
            raise AssertionError(f"mono pair {i}->{i + 1}: row {row.tolist()}, R error "
                                 f"{r_err[-1]}, t {t_deg[-1]} deg, launches {launches}")
    if out[1][1][14] < 8:
        raise AssertionError(f"mono pair 1->2: {out[1][1][14]} tracked points for the scale")
    # PnP on the second pair's chain-scaled points (|t01| = 1 units)
    fa, depth, scale = out[1][3]
    _, rescue = _pair_core(fa.desc, fa.valid, torch.stack([fa.x, fa.y], -1), depth, imgs[2],
                           intr, scale, cfg, mcfg, rcfg, step_generators(dev, 0, 2, 1)[0])
    p = find_pnp(rescue.pts_a3, rescue.xb, rescue.have3d, rcfg,
                 torch.Generator(device=dev).manual_seed(7))
    _, t01 = _rel_gt(seq.poses_r, seq.poses_t, 0, 1)
    r12, t12 = _rel_gt(seq.poses_r, seq.poses_t, 1, 2)
    t_exp = t12 / np.linalg.norm(t01)
    pr, pt = p.r.cpu().numpy(), p.t.cpu().numpy()
    pnp_r_err = float(np.abs(pr - r12).max())
    pnp_t_rel = float(np.linalg.norm(pt - t_exp) / np.linalg.norm(t_exp))
    if not (bool(p.ok) and pnp_r_err < MONO_PAIR_R_ERR and pnp_t_rel < MONO_PNP_T_REL):
        raise AssertionError(f"mono pair PnP: ok {bool(p.ok)}, R error {pnp_r_err}, "
                             f"t relative error {pnp_t_rel}")
    fa, depth, scale = out[1][3]
    args = (fa.desc, fa.valid, torch.stack([fa.x, fa.y], -1), depth, imgs[2], intr, scale,
            cfg, mcfg, rcfg)
    times = wall_ms(lambda: pair_step(*args, step_generators(dev, 0, 2, 2)), timed_runs)
    sim3 = check_sim3(dev)
    log("mono_pair", image="x".join(map(str, seq.images_l.shape[-2:])),
        r_err=",".join(f"{e:.5f}" for e in r_err), t_deg=",".join(f"{d:.3f}" for d in t_deg),
        inliers=",".join(str(int(o[1][13])) for o in out),
        scale_common_pair2=int(out[1][1][14]), scale_pair2=f"{out[1][1][12]:.5f}",
        kpts=int(out[1][0].feats.valid.sum()), pnp_inliers=int(p.num_inliers),
        pnp_r_err=f"{pnp_r_err:.5f}", pnp_t_rel_err=f"{pnp_t_rel:.5f}",
        pnp_t_deg=f"{_ang_deg(pt, t12):.3f}",
        pair_ms=_spread(times), launches=json.dumps(out[1][2]), card=json.dumps(smi_line()))
    return dict(launches=out[1][2], ms=statistics.median(times), sim3=sim3)


VO_CFG = dict(max_keyframes=96, kf_every=4, loop_temporal_gap=30, loop_min_inliers=25,
              loop_min_score=0.05, loop_min_common=8)     # tests/test_vo_sequence.py:45-51
VO_MIN_TRACKED = 0.9
VO_MIN_KF = 20
VO_ATE_OF_PATH = 0.15
VO_WARMUP_FRAMES = 16


def _vo_timers(vo) -> dict:
    """Host ms of a MonoVO's keyframe events (`_maybe_keyframe` calls that
    inserted one), Sim(3) solves and window BAs, with the events' K1/K2
    launches, by wrapping the instance's methods (the code is unchanged)."""
    from cusift_tpu_torch.kernels import matcher, sampler

    st = dict(event_ms=[], event_k1=0, event_k2=0, sim3_ms=[], ba_ms=[], frame_end=[])

    def wrap(name, key):
        fn = getattr(vo, name)

        def timed(*a):
            n0, k1_0, k2_0 = vo.n_kf_total, sampler.launches, matcher.launches
            t0 = time.perf_counter()
            r = fn(*a)
            ms = (time.perf_counter() - t0) * 1e3
            if key != "event_ms" or vo.n_kf_total > n0:
                st[key].append(ms)
            if key == "event_ms" and vo.n_kf_total > n0:
                st["event_k1"] += sampler.launches - k1_0
                st["event_k2"] += matcher.launches - k2_0
            return r
        setattr(vo, name, timed)

    wrap("_maybe_keyframe", "event_ms")
    wrap("_optimize_graph", "sim3_ms")
    wrap("_window_ba", "ba_ms")
    vo.on_metric = lambda stat: st["frame_end"].append(time.perf_counter())
    return st


def mono_vo_run(dev, seq, n_frames: int) -> dict:
    """MonoVO.run over the scene's first n_frames left images, after an
    untimed warm-up on its own instance; returns the run's record."""
    from cusift_tpu_torch import SiftConfig, VOConfig
    from cusift_tpu_torch.data.evaluation import (ate_rmse, camera_centers, horn_align,
                                                  kitti_drift, trajectory_path_length)
    from cusift_tpu_torch.kernels import matcher, sampler
    from cusift_tpu_torch.models.odometry import MonoVO

    cfg = SiftConfig(**STEREO_SIFT)

    def build():
        return MonoVO(seq.intr, sift_cfg=cfg, vo_cfg=VOConfig(**VO_CFG), ba_window=4, device=dev)

    frames = seq.images_l[:n_frames]
    n_k1 = 2 * cfg.num_octaves_for(*frames.shape[-2:])
    t0 = time.perf_counter()
    warm = build()
    reset_counts()
    with first_calls(sampler, "sample_grad_patches",
                     lambda: sampler.launches if n_k1 <= sampler.launches < 2 * n_k1 else None
                     ) as k1_in:
        warm.run(iter(frames[:VO_WARMUP_FRAMES]))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    vo = build()
    st = _vo_timers(vo)
    in_loop = [False]
    verify = vo._try_loop_closure

    def flagged():
        in_loop[0] = True
        try:
            return verify()
        finally:
            in_loop[0] = False
    vo._try_loop_closure = flagged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t_start = time.perf_counter()
    with (first_calls(matcher, "top2", lambda: "loop" if in_loop[0] else "pair") as k2_in,
          first_segment_calls("vo sim3", 1) as seg_in):
        er, et = vo.run(iter(frames))
    t_end = time.perf_counter()
    launches = read_counts()
    gt_r, gt_t = seq.poses_r[:n_frames], seq.poses_t[:n_frames]
    path = float(trajectory_path_length(gt_r, gt_t)[-1])
    ate = ate_rmse(er, et, gt_r, gt_t, with_scale=True)
    raw_r, raw_t = np.stack(vo.poses_r), np.stack(vo.poses_t)
    ate_raw = ate_rmse(raw_r, raw_t, gt_r, gt_t, with_scale=True)
    s, _, _ = horn_align(camera_centers(er, et), camera_centers(gt_r, gt_t), with_scale=True)
    drift, rot_drift = kitti_drift(er, (et * s).astype(np.float32), gt_r, gt_t,
                                   lengths=(0.25 * path, 0.5 * path), step=2)
    tracked = sum(1 for x in vo.stats if x["ok"])
    others = sum(launches[k] for k in ("octave", "ori_hist", "desc_raw", "sep"))
    marks = st["frame_end"]
    frame_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    n_ev = len(st["event_ms"])
    out = dict(frames=n_frames, tracked=tracked, keyframes=vo.n_kf_total, ring=vo.n_kf,
               closures=vo.n_closures, gate_rejects=vo.n_gate_rejects, ate=ate,
               ate_raw=ate_raw, path=path, drift_pct=drift, rot_drift=rot_drift,
               fps=(n_frames - 1) / (t_end - t_start), frame_ms=frame_ms,
               launches=launches, n_events=n_ev, st=st, warmup_s=warmup_s,
               rescued=sum(1 for x in vo.stats if x["pnp_ok"]), gate_log=vo.gate_log,
               k1_in=[k1_in[i] for i in sorted(k1_in)], n_k1=n_k1, k2_in=k2_in,
               k1_per_frame=(launches["sampler"] - st["event_k1"]) / n_frames,
               k2_per_frame=(launches["matcher"] - st["event_k2"]) / (n_frames - 1),
               k1_per_event=st["event_k1"] / max(n_ev, 1),
               k2_per_event=st["event_k2"] / max(n_ev, 1),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, segment_in=seg_in,
               bars=(tracked >= VO_MIN_TRACKED * len(vo.stats) and vo.n_kf >= VO_MIN_KF
                     and vo.n_closures >= 1 and ate < VO_ATE_OF_PATH * path and not others
                     and launches["sampler"] > 0 and launches["matcher"] > 0))
    log("mono_vo", image="x".join(map(str, frames.shape[-2:])), frames=n_frames,
        warmup_s=f"{warmup_s:.3f}", tracked=tracked, pairs=len(vo.stats),
        rescued=out["rescued"], keyframes=vo.n_kf_total, ring=vo.n_kf,
        closures=vo.n_closures, gate_rejects=vo.n_gate_rejects, ate=f"{ate:.6f}",
        path=f"{path:.4f}", ate_of_path=f"{ate / path:.5f}",
        raw_ate_of_path=f"{ate_raw / path:.5f}", corrected_over_raw=f"{ate / ate_raw:.4f}",
        kitti_drift_pct=f"{drift:.4f}", rot_drift_deg_per_m=f"{rot_drift:.4f}",
        fps=f"{out['fps']:.3f}", frame_ms=_spread(frame_ms),
        events=n_ev, event_ms=_spread(st["event_ms"]), sim3_ms=_spread(st["sim3_ms"]),
        window_ba_ms=_spread(st["ba_ms"]), k1_per_frame=f"{out['k1_per_frame']:.2f}",
        k2_per_pair=f"{out['k2_per_frame']:.2f}", k1_per_event=f"{out['k1_per_event']:.2f}",
        k2_per_event=f"{out['k2_per_event']:.2f}", peak_mem_gb=f"{out['peak_mem_gb']:.3f}",
        launches=json.dumps(launches), card=json.dumps(smi_line()))
    log("mono_vo", gate_log=json.dumps(vo.gate_log))
    return out


def mono_vo_path(dev, seq) -> dict:
    """Phase 20: MonoVO.run on the north-star scene's left images at full
    width (the reference soak's VOConfig, ba_window 4).  If no closure
    fires in STEREO_FRAMES frames, the scene's 300 frames are rendered and
    run instead; every other bar stays."""
    run = mono_vo_run(dev, seq, STEREO_FRAMES)
    if run["closures"] == 0:
        log("mono_vo", no_closure_at=STEREO_FRAMES, rerun_frames=300)
        from cusift_tpu_torch.data.synthetic import two_plane_stereo_sequence
        seq = two_plane_stereo_sequence(300, 480, 640, **STEREO_SCENE)
        run = mono_vo_run(dev, seq, 300)
    if (not run["bars"] or len(run["k1_in"]) != run["n_k1"]
            or set(run["k2_in"]) != {"pair", "loop"}):
        raise AssertionError(
            f"mono VO: tracked {run['tracked']}/{run['frames'] - 1}, keyframes "
            f"{run['keyframes']}, closures {run['closures']}, ATE {run['ate']} of path "
            f"{run['path']}, launches {run['launches']}, K1 inputs {len(run['k1_in'])}, "
            f"K2 inputs {sorted(run['k2_in'])}")
    return run


SFM_RGBD_SCENE = dict(seed=0, motion_scale=0.6, detail=0.25, detail_octaves=4)
SFM_MONO_SCENE = dict(seed=3, motion_scale=0.8)


def sfm_path(dev) -> dict:
    """Phase 21: reconstruct_rgbd as `cli.py sfm` calls it on a 10-frame
    480x640 planar snippet, and reconstruct_mono on the 10-frame two-plane
    scene, both at 2048 keypoints, each held to tests/test_sfm.py's bars."""
    from cusift_tpu_torch import BAConfig, RansacConfig, SiftConfig
    from cusift_tpu_torch.data.evaluation import ate_rmse, trajectory_path_length
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, two_plane_sequence
    from cusift_tpu_torch.models.sfm import reconstruct_mono, reconstruct_rgbd

    cfg = SiftConfig(**SLAM_SIFT)
    seq = planar_rgbd_sequence(10, 480, 640, **SFM_RGBD_SCENE)
    reset_counts()
    t0 = time.perf_counter()
    rec = reconstruct_rgbd(seq.images, seq.depths, seq.intr, sift_cfg=cfg,
                           ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                           ba_cfg=BAConfig(huber_delta=4.0, num_fixed_poses=2), device=dev)
    rgbd_s = time.perf_counter() - t0
    rgbd_launches = read_counts()
    ate = ate_rmse(rec.poses_r, rec.poses_t, seq.poses_r, seq.poses_t)
    z_err = float(np.median(np.abs(rec.points[:, 2] - 2.0)))
    c, c0 = float(rec.ba.cost), float(rec.ba.initial_cost)
    if not (rec.n_tracks > 40 and rec.n_obs >= 2 * rec.n_tracks and c < c0
            and np.isfinite(rec.points).all() and ate < 0.02 and z_err < 0.05):
        raise AssertionError(f"sfm rgbd: tracks {rec.n_tracks}, obs {rec.n_obs}, BA {c0} -> "
                             f"{c}, ATE {ate}, median |z - 2| {z_err}")
    log("sfm", kind="rgbd", image="x".join(map(str, seq.images.shape[-2:])), frames=10, tracks=rec.n_tracks, obs=rec.n_obs,
        ba_cost=f"{c0:.6g}->{c:.6g}", ate_m=f"{ate:.6f}", median_z_err=f"{z_err:.6f}",
        seconds=f"{rgbd_s:.3f}", launches=json.dumps(rgbd_launches),
        card=json.dumps(smi_line()))

    mseq = two_plane_sequence(10, 480, 640, **SFM_MONO_SCENE)
    reset_counts()
    t0 = time.perf_counter()
    with first_segment_calls("sfm mono BA") as seg_in:
        mrec = reconstruct_mono(mseq.images, mseq.intr, sift_cfg=cfg, device=dev)
    mono_s = time.perf_counter() - t0
    mono_launches = read_counts()
    # the same call again: deterministic segment sums give the same bits
    t0 = time.perf_counter()
    again = reconstruct_mono(mseq.images, mseq.intr, sift_cfg=cfg, device=dev)
    rerun_s = time.perf_counter() - t0
    same = (again.n_tracks == mrec.n_tracks and again.n_obs == mrec.n_obs
            and all(np.array_equal(getattr(again, k), getattr(mrec, k))
                    for k in ("poses_r", "poses_t", "points"))
            and all(torch.equal(a, b) for a, b in zip(again.ba, mrec.ba)))
    if not same:
        raise AssertionError(f"sfm mono rerun: tracks {mrec.n_tracks} -> {again.n_tracks}, "
                             f"obs {mrec.n_obs} -> {again.n_obs}, cost {float(mrec.ba.cost)} "
                             f"-> {float(again.ba.cost)}")
    path = float(trajectory_path_length(mseq.poses_r, mseq.poses_t)[-1])
    mate = ate_rmse(mrec.poses_r, mrec.poses_t, mseq.poses_r, mseq.poses_t, with_scale=True)
    # structure numbers (tests/test_sfm.py's, failing in the reference too)
    z0 = (mrec.points @ mrec.poses_r[0].T + mrec.poses_t[0])[:, 2]
    z0 = z0[np.abs(z0) > 1e-6]
    front = float(np.mean(z0 > 0)) if z0.size else float("nan")
    zf = z0[z0 > 0]
    ratio = (float(np.median(zf[zf > np.median(zf)]) / np.median(zf[zf <= np.median(zf)]))
             if zf.size > 2 else float("nan"))
    if not (mrec.n_tracks >= 100 and mrec.n_obs >= 2 * mrec.n_tracks and mate < 0.05 * path):
        raise AssertionError(f"sfm mono: tracks {mrec.n_tracks}, obs {mrec.n_obs}, ATE {mate} "
                             f"of path {path}")
    log("sfm", kind="mono", image="x".join(map(str, mseq.images.shape[-2:])), frames=10, tracks=mrec.n_tracks, obs=mrec.n_obs,
        ba_cost=f"{float(mrec.ba.initial_cost):.6g}->{float(mrec.ba.cost):.6g}",
        ate=f"{mate:.6f}", ate_of_path=f"{mate / path:.5f}", in_front_of_init=f"{front:.4f}",
        far_near_ratio=f"{ratio:.4f}", seconds=f"{mono_s:.3f}", rerun_bit_equal=same,
        rerun_seconds=f"{rerun_s:.3f}", launches=json.dumps(mono_launches),
        card=json.dumps(smi_line()))
    others = sum(rgbd_launches[k] + mono_launches[k]
                 for k in ("octave", "ori_hist", "desc_raw", "sep"))
    if others or not all(l["sampler"] and l["matcher"] and l["segment"]
                         for l in (rgbd_launches, mono_launches)):
        raise AssertionError(f"sfm launches {rgbd_launches} {mono_launches}")
    return dict(rgbd=rgbd_launches, mono=mono_launches, segment_in=seg_in)


def check_matcher_vo(dev, calls) -> dict:
    """K2 at the VO path's inputs: its first pair-step match and its first
    loop-verification match (2048 x 2048), each against its plain version
    and timed."""
    out = {}
    for kind in ("pair", "loop"):
        ta, tb, tv = calls[kind]
        err = _k2_case(f"vo {kind}", ta, tb, tv)
        out[kind] = dict(max_abs_err=err, valid_b=int(tv.sum()),
                         **_k2_timed(f"k2 vo {kind}", ta, tb, tv))
    return dict(max_abs_err=max(o["max_abs_err"] for o in out.values()), **out)


# ---------- phases 28-29: the map-anchored mono path, the segment sums ----------

def _map_timers(vo) -> tuple[dict, contextlib.AbstractContextManager]:
    """Host ms of each `localize_step` and `insert_step` call of a MonoVO
    (the module functions it calls, wrapped; the device is synchronised
    around each, so a call's ms is its device work and its dispatch), and
    a flag that says a call of `localize_step` is under way."""
    from cusift_tpu_torch.models import odometry

    st = dict(localize_ms=[], insert_ms=[], in_localize=[False], frame_end=[])

    def timed(fn, key):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st["in_localize"][0] = key == "localize_ms"
            try:
                r = fn(*a, **k)
            finally:
                st["in_localize"][0] = False
            torch.cuda.synchronize()
            st[key].append((time.perf_counter() - t0) * 1e3)
            return r
        return call

    @contextlib.contextmanager
    def patched():
        loc, ins = odometry.localize_step, odometry.insert_step
        odometry.localize_step = timed(loc, "localize_ms")
        odometry.insert_step = timed(ins, "insert_ms")
        try:
            yield
        finally:
            odometry.localize_step, odometry.insert_step = loc, ins

    vo.on_metric = lambda stat: st["frame_end"].append(time.perf_counter())
    return st, patched()


def map_vo_path(dev, seq, chain: dict) -> dict:
    """Phase 28: MonoVO(map_anchor=True) over the scene's 150 left images
    at full width (phase 20's VOConfig and ba_window 4, the map at its
    defaults), after an untimed warm-up that keeps K2's first
    `localize_step` input with live landmarks; `chain` is phase 20's run."""
    from cusift_tpu_torch import SiftConfig, VOConfig
    from cusift_tpu_torch.data.evaluation import ate_rmse, trajectory_path_length
    from cusift_tpu_torch.kernels import matcher
    from cusift_tpu_torch.models.odometry import MonoVO

    cfg = SiftConfig(**STEREO_SIFT)
    vo_cfg = VOConfig(**VO_CFG, map_anchor=True)
    n_frames = STEREO_FRAMES
    frames = seq.images_l[:n_frames]

    def build():
        return MonoVO(seq.intr, sift_cfg=cfg, vo_cfg=vo_cfg, ba_window=4, device=dev)

    t0 = time.perf_counter()
    warm = build()
    wst, patched = _map_timers(warm)
    k2_in, top2 = {}, matcher.top2

    def keep_first(ta, tb, tv):
        if wst["in_localize"][0] and "map" not in k2_in and bool(tv.any()):
            k2_in["map"] = (ta.clone(), tb.clone(), tv.clone())
        return top2(ta, tb, tv)

    matcher.top2 = keep_first
    try:
        with patched, first_segment_calls("map refine", 2, live=True) as seg_in:
            warm.run(iter(frames[:VO_WARMUP_FRAMES]))
    finally:
        matcher.top2 = top2
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    if "map" not in k2_in:
        raise AssertionError("map VO warm-up: no localize_step match against live landmarks")

    vo = build()
    st, patched = _map_timers(vo)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t_start = time.perf_counter()
    with patched:
        er, et = vo.run(iter(frames))
    t_end = time.perf_counter()
    launches = read_counts()
    gt_r, gt_t = seq.poses_r[:n_frames], seq.poses_t[:n_frames]
    path = float(trajectory_path_length(gt_r, gt_t)[-1])
    ate = ate_rmse(er, et, gt_r, gt_t, with_scale=True)
    stats = vo.stats
    tracked = sum(1 for x in stats if x["ok"] or x["pnp_ok"])
    localised = sum(1 for x in stats if x["pnp_ok"])
    anchored = [x for x in stats if x["map_n_anchor"] > 0]
    s_ratio = [x["map_s_med"] / x["scale"] for x in anchored
               if np.isfinite(x["map_s_med"]) and x["scale"] > 0]
    marks = st["frame_end"]
    frame_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    n_map = int(vo._lmap.valid.sum())
    others = sum(launches[k] for k in ("octave", "ori_hist", "desc_raw", "sep"))
    out = dict(frames=n_frames, tracked=tracked, localised=localised, ate=ate, path=path,
               fps=(n_frames - 1) / (t_end - t_start), frame_ms=frame_ms,
               localize_ms=st["localize_ms"], insert_ms=st["insert_ms"], launches=launches,
               keyframes=vo.n_kf_total, closures=vo.n_closures, landmarks=n_map,
               warmup_s=warmup_s, k2_in=k2_in, segment_in=seg_in,
               k1_per_frame=launches["sampler"] / n_frames,
               k2_per_frame=launches["matcher"] / (n_frames - 1),
               segment_per_frame=launches["segment"] / (n_frames - 1),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log("map_vo", image="x".join(map(str, frames.shape[-2:])), frames=n_frames,
        warmup_s=f"{warmup_s:.3f}", tracked=tracked, pairs=len(stats),
        pair_ok=sum(1 for x in stats if x["ok"]), map_localised=localised,
        map_share=f"{localised / len(stats):.4f}", keyframes=vo.n_kf_total, ring=vo.n_kf,
        closures=vo.n_closures, gate_rejects=vo.n_gate_rejects, landmarks=n_map,
        median_n_anchor=(statistics.median(x["map_n_anchor"] for x in stats)),
        median_s_med_over_scale=(f"{statistics.median(s_ratio):.4f}" if s_ratio else "none"),
        ate=f"{ate:.6f}", path=f"{path:.4f}", ate_of_path=f"{ate / path:.5f}",
        chain_ate_of_path=f"{chain['ate'] / chain['path']:.5f}", fps=f"{out['fps']:.3f}",
        chain_fps=f"{chain['fps']:.3f}", frame_ms=_spread(frame_ms),
        chain_frame_ms=_spread(chain["frame_ms"]), localize_ms=_spread(st["localize_ms"]),
        insert_ms=_spread(st["insert_ms"]), inserts=len(st["insert_ms"]),
        k1_per_frame=f"{out['k1_per_frame']:.2f}", k2_per_pair=f"{out['k2_per_frame']:.2f}",
        chain_k2_per_pair=f"{chain['k2_per_frame']:.2f}",
        segment_per_pair=f"{out['segment_per_frame']:.2f}",
        peak_mem_gb=f"{out['peak_mem_gb']:.3f}", chain_peak_mem_gb=f"{chain['peak_mem_gb']:.3f}",
        launches=json.dumps(launches), card=json.dumps(smi_line()))
    if not (tracked >= VO_MIN_TRACKED * len(stats) and ate < VO_ATE_OF_PATH * path
            and st["insert_ms"] and n_map > 0 and not others and launches["sampler"] > 0
            and launches["matcher"] > 0 and launches["segment"] > 0):
        raise AssertionError(f"map VO: tracked {tracked}/{len(stats)}, localised {localised}, "
                             f"ATE {ate} of path {path}, inserts {len(st['insert_ms'])}, "
                             f"landmarks {n_map}, launches {launches}")
    return out


def check_matcher_map(dev, calls) -> dict:
    """K2 at `localize_step`'s first input with live landmarks: the
    frame's 2048 descriptors against the 8192-slot map, most columns
    masked by `active`; against its plain version and timed."""
    ta, tb, tv = calls["map"]
    err = _k2_case("map localize", ta, tb, tv)
    return dict(max_abs_err=err, valid_b=int(tv.sum()), shape=[ta.shape[0], tb.shape[0]],
                **_k2_timed("k2 map", ta, tb, tv))


SEGMENT_REL = 1e-4   # of each segment's sum of |x|: the card's atomics add in another order


def check_segment(dev, calls: dict) -> dict:
    """Phase 29: the segment-sum kernel at each input a path gave it,
    against its plain version (`index_add_`) on the same inputs: on the
    CPU, whose order of adds it repeats, bit for bit (`max_abs_err`); on
    the card, whose atomics add in another order, within SEGMENT_REL of
    each segment's sum of |x| (`atomics_rel_err`).  Timed beside
    `index_add_` on the card and beside `index_put_(accumulate=True)`;
    bound by the bytes of x, the indices and the output."""
    from cusift_tpu_torch.kernels import segment

    out = {}
    for tag, (x, p) in calls.items():
        got = segment.segment_sum(x, p)
        plain = segment.segment_sum_plain(x, p)
        cpu = segment.segment_sum_plain(x.cpu(), segment.plan(p.idx.cpu(), p.n))
        scale = segment.segment_sum_plain(x.abs(), p) + 1e-30
        torch.cuda.synchronize()
        err = float((got.cpu() - cpu).abs().max()) if got.numel() else 0.0
        rel = float(((got - plain).abs() / scale).max()) if got.numel() else 0.0
        if not torch.equal(got.cpu(), cpu) or not rel <= SEGMENT_REL:
            raise AssertionError(f"segment {tag}: max |kernel - CPU index_add_| {err}, "
                                 f"against the card's atomics {rel} of sum |x|")
        zeros = x.new_zeros(got.shape)
        ms = time_ms(lambda: segment.segment_sum(x, p), f"segment {tag}")
        plain_ms = time_ms(lambda: segment.segment_sum_plain(x, p), f"segment {tag} plain")
        library_ms = time_ms(lambda: zeros.clone().index_put_((p.idx,), x, accumulate=True),
                             f"segment {tag} library")
        rows, d = x.shape[0], max(1, x[0].numel()) if x.shape[0] else 1
        b = bound(nbytes(x, got) + p.idx.numel() * 8, rows * d)
        seg_len = int(torch.bincount(p.idx, minlength=p.n).max()) if rows else 0
        out[tag] = dict(shape=[rows, *x.shape[1:]], segments=p.n, longest=seg_len,
                        max_abs_err=err, atomics_rel_err=rel, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, **b)
        log("segment", case=tag, shape=f"R{rows},d{d},n{p.n}", longest=seg_len,
            max_abs_err_vs_cpu=err, atomics_rel_err=rel, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{b['bound_ms']:.6f}", card=json.dumps(smi_line()))
    return dict(max_abs_err=max(o["max_abs_err"] for o in out.values()), calls=out)


# ---------- phases 23-27: distribution, the CLI, disk, entry points ----------

DIST_BA_CFG = dict(max_iters=8, cg_iters=30, num_fixed_poses=2)    # tests/test_parallel.py:47
WIN_BA_CFG = dict(max_iters=5, cg_iters=15, num_fixed_poses=2, huber_delta=4.0)
DIST_RANKS = (2, 4)          # gloo ranks sharing the one card
CLI_TIMEOUT_S = 300


def _window_inputs(dev) -> list:
    """A 5-keyframe window at the SLAM path's width: frames 0-4 of phase
    14's orbit with 2048 keypoints, the three newest poses perturbed as
    tests/test_parallel.py:152 does (numpy arrays)."""
    from cusift_tpu_torch import SiftConfig
    from cusift_tpu_torch.data.synthetic import se3_exp
    from cusift_tpu_torch.models.slam import _extract_with_points

    seq, frames, _ = slam_setup(n_frames=5)
    intr = torch.from_numpy(seq.intr).to(dev)
    out = [_extract_with_points(torch.from_numpy(img).to(dev), torch.from_numpy(d).to(dev),
                                intr, SiftConfig(**SLAM_SIFT)) for img, d in frames]
    rs = np.random.default_rng(1)
    pr, pt = seq.poses_r.copy(), seq.poses_t.copy()
    for k in (2, 3, 4):
        dr, dt = se3_exp(rs.normal(scale=0.02, size=6))
        pr[k] = dr @ seq.poses_r[k]
        pt[k] = dr @ seq.poses_t[k] + dt
    return [torch.stack([o[0].desc for o in out]).cpu().numpy(),
            torch.stack([o[0].valid for o in out]).cpu().numpy(),
            torch.stack([o[1] for o in out]).cpu().numpy(),
            pr.astype(np.float32), pt.astype(np.float32), seq.intr, np.ones(5, np.float32)]


def _close(tag, got, ref, rtol, atol) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    if not np.allclose(got, ref, rtol=rtol, atol=atol):
        raise AssertionError(f"{tag}: max |diff| {np.abs(got - ref).max()} "
                             f"(rtol {rtol}, atol {atol})")
    return float(np.abs(got - ref).max())


def _hold_dist(tag, ba, single, parts, win, win_ref, pg, pg_ref) -> dict:
    """The distributed results against the single-device ones at the CPU
    tests' tolerances (test_torch_dist_ba.py, test_torch_dist_pg.py)."""
    from cusift_tpu_torch.parallel.dist_ba import gather_points

    err = dict(
        ba_cost0=_close(f"{tag} BA initial cost", float(ba.initial_cost),
                        float(single.initial_cost), 1e-4, 0),
        ba_poses=max(_close(f"{tag} BA t", ba.poses_t.cpu(), single.poses_t.cpu(), 1e-3, 1e-4),
                     _close(f"{tag} BA R", ba.poses_r.cpu(), single.poses_r.cpu(), 1e-3, 1e-4)),
        ba_points=_close(f"{tag} BA points", gather_points(parts, ba.points),
                         single.points.cpu(), 1e-3, 1e-3),
        window_cost0=_close(f"{tag} window cost", float(win[2]), float(win_ref[2]), 1e-4, 0),
        window_poses=max(_close(f"{tag} window t", win[1].cpu(), win_ref[1].cpu(), 0, 5e-4),
                         _close(f"{tag} window R", win[0].cpu(), win_ref[0].cpu(), 0, 5e-4)),
        pg_cost=_close(f"{tag} graph cost", float(pg.cost), float(pg_ref.cost), 1e-4, 0),
        pg_poses=_close(f"{tag} graph t", pg.poses_t.cpu(), pg_ref.poses_t.cpu(), 1e-3, 1e-4))
    if not float(win[3]) <= float(win[2]):
        raise AssertionError(f"{tag}: window BA cost {float(win[2])} -> {float(win[3])}")
    return err


@contextlib.contextmanager
def _counted_all_reduces():
    """Counts the `torch.distributed.all_reduce` calls made inside the
    block (read from the yielded one-element list after it)."""
    import torch.distributed as dist

    count, plain = [0], dist.all_reduce

    def counted(*args, **kwargs):
        count[0] += 1
        return plain(*args, **kwargs)

    dist.all_reduce = counted
    try:
        yield count
    finally:
        dist.all_reduce = plain


def dist_path(dev) -> dict:
    """Phase 23: the distributed solvers on a one-rank NCCL group on the
    card (`distributed_bundle_adjust`, `window_ba_dist`,
    `distributed_pg_optimize` against `bundle_adjust`, `window_ba`,
    `optimize`), with the all-reduces per LM iteration and their time;
    then the same on 2 and 4 gloo ranks sharing the card."""
    import torch.distributed as dist

    from cusift_tpu_torch import BAConfig, MatchConfig, PoseGraphConfig
    from cusift_tpu_torch.data.synthetic import ba_problem, pose_ring
    from cusift_tpu_torch.models.local_ba import window_ba
    from cusift_tpu_torch.optim.ba import BAProblem, bundle_adjust
    from cusift_tpu_torch.optim.posegraph import PoseGraph, optimize
    from cusift_tpu_torch.parallel import launch, mesh as mesh_mod
    from cusift_tpu_torch.parallel.dist_ba import (distributed_bundle_adjust,
                                                   partition_by_landmark, window_ba_dist)
    from cusift_tpu_torch.parallel.dist_pg import distributed_pg_optimize, partition_edges
    from cusift_tpu_torch.utils.collective import psum

    mesh_mod.ensure_group(dev)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"expected a one-rank NCCL group, got {dist.get_backend()} x "
                             f"{dist.get_world_size()}")
    mesh = mesh_mod.map_mesh()
    cfg, win_cfg = BAConfig(**DIST_BA_CFG), BAConfig(**WIN_BA_CFG)
    prob, _ = ba_problem(seed=3, n_cams=6, n_pts=64, pixel_noise=0.25)
    single = bundle_adjust(BAProblem(**{k: torch.from_numpy(np.asarray(v)).to(dev)
                                        for k, v in prob.items()}), cfg)
    parts1 = partition_by_landmark(prob, 1)
    wargs = _window_inputs(dev)
    wt = [torch.from_numpy(np.asarray(a)).to(dev) for a in wargs]
    ring = pose_ring(n=24, drift=0.03, seed=2)
    w_edges = np.ones(len(ring["edge_i"]), np.float32)
    pg_cfg = PoseGraphConfig(max_iters=10, cg_iters=50)
    keys = ("init_r", "init_t", "edge_i", "edge_j", "meas_r", "meas_t")
    pg_ref = optimize(PoseGraph(*(torch.from_numpy(np.asarray(ring[k])).to(dev) for k in keys),
                                torch.from_numpy(w_edges).to(dev)), pg_cfg)
    win_ref = window_ba(*wt, MatchConfig(), win_cfg)

    def graph(n):
        p = partition_edges(ring["edge_i"], ring["edge_j"], ring["meas_r"], ring["meas_t"],
                            w_edges, n)
        return dict(poses_r=ring["init_r"], poses_t=ring["init_t"], **p)

    g1 = PoseGraph(*(torch.as_tensor(np.asarray(graph(1)[k]), device=dev)
                     for k in PoseGraph._fields))
    reset_counts()
    with _counted_all_reduces() as r_ba:
        ba = distributed_bundle_adjust(parts1, mesh, cfg, device=dev)
    with _counted_all_reduces() as r_win:
        win = window_ba_dist(*wt, mesh, MatchConfig(), win_cfg)
    with _counted_all_reduces() as r_pg:
        pg = distributed_pg_optimize(g1, mesh, pg_cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    r_ba, r_win, r_pg = r_ba[0], r_win[0], r_pg[0]
    if launches["matcher"] == 0:
        raise AssertionError(f"dist launches {launches}: window_ba_dist's association ran no K2")
    err1 = _hold_dist("1-rank nccl", ba, single, parts1, win, win_ref, pg, pg_ref)

    # an all-reduce of the camera system's [C, 6] partial sums, timed alone
    x = torch.randn(5, 6, device=dev)
    reduce_ms = time_ms(lambda: psum(x, mesh.get_group(mesh_mod.MAP)), "nccl all-reduce [5, 6]",
                        iters=200)
    t_solve = wall_ms(lambda: window_ba_dist(*wt, mesh, MatchConfig(), win_cfg), 5)
    t_single = wall_ms(lambda: window_ba(*wt, MatchConfig(), win_cfg), 5)
    per_iter = dict(ba=r_ba / cfg.max_iters, window=r_win / win_cfg.max_iters,
                    graph=r_pg / pg_cfg.max_iters)
    log("dist", ranks=1, backend="nccl", errors=json.dumps(err1),
        all_reduces=json.dumps(dict(ba=r_ba, window=r_win, graph=r_pg)),
        all_reduces_per_lm_iter=json.dumps(per_iter), all_reduce_ms=f"{reduce_ms:.5f}",
        window_dist_ms=_spread(t_solve), window_single_ms=_spread(t_single),
        window_n=int(wargs[1].shape[1]), launches=json.dumps(launches),
        card=json.dumps(smi_line()))

    # the 2- and 4-rank cases on one spawn of 4 gloo ranks sharing the card
    t0 = time.perf_counter()
    parts = {n: partition_by_landmark(prob, n) for n in DIST_RANKS}
    jobs = {n: dict(parts=parts[n], cfg=cfg, window_args=wargs, window_cfg=win_cfg,
                    pg_jobs=[(graph(n), pg_cfg)]) for n in DIST_RANKS}
    runs = launch.per_size(launch.run(launch.ba_task, max(DIST_RANKS), args=(jobs,),
                                      backend="gloo", device="cuda"))
    secs = time.perf_counter() - t0
    ranks = {}
    for n in DIST_RANKS:
        out = runs[n]
        a = out[0]
        for other in out[1:]:
            if not all(torch.equal(u, v) for u, v in zip(a["ba"], other["ba"])):
                raise AssertionError(f"{n} gloo ranks: the ranks' BA results differ")
        err = _hold_dist(f"{n}-rank gloo", a["ba"], single, parts[n], a["window"], win_ref,
                         a["pg"][0], pg_ref)
        k = {key: sum(o["launches"][key] for o in out) for key in ("sampler", "matcher")}
        ranks[n] = dict(errors=err, launches=k)
        log("dist", ranks=n, backend="gloo", tensors="cuda", staged_through_host=True,
            errors=json.dumps(err), launches=json.dumps(k), card=json.dumps(smi_line()))
    log("dist", gloo_spawn_ranks=max(DIST_RANKS), seconds=f"{secs:.3f}")
    return dict(launches=launches, gloo=ranks, all_reduce_ms=reduce_ms, per_iter=per_iter)


def dist_slam_path(dev, slam_stats: dict) -> dict:
    """Phase 24: Slam(dist_ba=True) on phase 14's orbit, one NCCL rank,
    after the same untimed warm-up: trajectory within 1e-3 m of phase 14's,
    the same keyframes, frames/s beside phase 14's."""
    seq, frames, build = slam_setup()
    build(dev, dist_ba=True).run(iter(frames[:WARMUP_FRAMES]))
    slam = build(dev, dist_ba=True)
    ends = []
    slam.on_metric = lambda rec: ends.append(time.perf_counter())
    torch.cuda.synchronize()
    reset_counts()
    recs = slam.run(iter(frames))
    t_end = time.perf_counter()
    launches = read_counts()
    fps = (SLAM_FRAMES - 1) / (t_end - ends[0])
    r, t = slam.trajectory()
    r14, t14 = slam_stats["trajectory"]
    dev_m = float(np.abs(t - t14).max())
    tracked = sum(1 for rec in recs if rec.get("tracked", True))
    ate = slam.ate(seq.poses_r, seq.poses_t)
    if (slam._ba_mesh is None or tracked != SLAM_FRAMES or dev_m > 1e-3
            or slam.state.n_kf_total != slam_stats["keyframes"] or not ate < MAX_ATE
            or launches["sampler"] == 0 or launches["matcher"] == 0):
        raise AssertionError(f"dist slam: tracked {tracked}, max |t - phase 14| {dev_m}, "
                             f"keyframes {slam.state.n_kf_total} vs {slam_stats['keyframes']}, "
                             f"ATE {ate}, launches {launches}")
    log("dist_slam", ranks=1, backend="nccl", frames=SLAM_FRAMES, tracked=tracked,
        keyframes=slam.state.n_kf_total, closures=slam.state.n_closures, ate_m=f"{ate:.6f}",
        max_t_vs_phase14_m=f"{dev_m:.3g}", fps_after_first=f"{fps:.3f}",
        phase14_fps=f"{slam_stats['fps']:.3f}", launches=json.dumps(launches),
        card=json.dumps(smi_line()))
    return dict(launches=launches, fps=fps)


TORCHRUN = (sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1")


def _cli(args: list, tag: str, launcher=()) -> tuple[str, float, dict]:
    """`python -m cusift_tpu_torch.cli ARGS` on the card (under `launcher`,
    e.g. torchrun, when given): its output, wall seconds and kernel
    launches (its last line); a non-zero exit raises."""
    t0 = time.perf_counter()
    cmd = [*launcher] if launcher else [sys.executable]
    proc = subprocess.run([*cmd, "-m", "cusift_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {tag} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    out = proc.stdout
    counts = json.loads(out.strip().splitlines()[-1].split("kernel launches: ", 1)[1])
    return out, secs, counts


def _num(out: str, prefix: str, after: str) -> float:
    line = next(l for l in out.splitlines() if l.startswith(prefix))
    return float(line.split(after, 1)[1].split()[0])


def _path_len(poses_r, poses_t) -> float:
    from cusift_tpu_torch.data.evaluation import trajectory_path_length

    return float(trajectory_path_length(poses_r, poses_t)[-1])


def cli_path() -> dict:
    """Phase 25: every CLI command on the card as a subprocess at its
    defaults, held to phases 5, 14, 18, 20-21's bars."""
    from cusift_tpu_torch.data.synthetic import two_plane_sequence, two_plane_stereo_sequence

    odo_seq = two_plane_sequence(n_frames=8, h=480, w=640, seed=0)
    st_seq = two_plane_stereo_sequence(n_frames=8, h=240, w=320, seed=0, motion_scale=0.7,
                                       amplitude=2.0)
    runs = {}

    def run(tag, args, checks, launcher=()):
        out, secs, counts = _cli(args, tag, launcher)
        vals = checks(out)
        runs[tag] = dict(seconds=secs, launches=counts, **vals)
        log("cli", command=json.dumps(" ".join(args)), seconds=f"{secs:.3f}",
            launches=json.dumps(counts), **{k: f"{v:.6g}" for k, v in vals.items()},
            card=json.dumps(smi_line()))

    def bar(ok, tag, vals):
        if not ok:
            raise AssertionError(f"cli {tag}: {vals}")
        return vals

    run("demo", ["demo"], lambda o: bar(_num(o, "corner error", "truth:") < MAX_CORNER_ERR,
                                        "demo", dict(corner_px=_num(o, "corner error", "truth:"))))
    run("slam", ["slam", "--synthetic", "12"],
        lambda o: bar(_num(o, "ATE RMSE", "ATE RMSE") < MAX_ATE, "slam",
                      dict(ate_m=_num(o, "ATE RMSE", "ATE RMSE"))))
    # the documented multi-process form, one rank: torchrun's environment,
    # NCCL, the distributed window BA; the same trajectory as above
    run("slam --dist", ["slam", "--synthetic", "12", "--dist"],
        lambda o: bar("BA sharded over 1 rank(s)" in o
                      and _num(o, "ATE RMSE", "ATE RMSE") == runs["slam"]["ate_m"],
                      "slam --dist", dict(ate_m=_num(o, "ATE RMSE", "ATE RMSE"))),
        launcher=TORCHRUN)
    odo_path = _path_len(odo_seq.poses_r, odo_seq.poses_t)
    def odo_checks(o):
        ok, pairs = (int(v) for v in next(l for l in o.splitlines() if "pairs tracked" in l)
                     .split("; ")[1].split()[0].split("/"))
        vals = dict(ate=_num(o, "ATE RMSE (Sim3", "aligned)"), path=odo_path, tracked=ok,
                    pairs=pairs)
        return bar(vals["ate"] < VO_ATE_OF_PATH * odo_path and ok >= VO_MIN_TRACKED * pairs,
                   "odo", vals)

    run("odo", ["odo", "--synthetic", "8", "--loop"], odo_checks)
    st_path = _path_len(st_seq.poses_r, st_seq.poses_t)
    run("stereo", ["stereo", "--synthetic", "8"],
        lambda o: bar(_num(o, "metric ATE RMSE", "RMSE") < STEREO_ATE_OF_PATH * st_path, "stereo",
                      dict(ate_m=_num(o, "metric ATE RMSE", "RMSE"), path_m=st_path)))
    run("sfm", ["sfm", "--synthetic", "8"],
        lambda o: bar(_num(o, "ATE RMSE vs", "truth:") < 0.02, "sfm",
                      dict(ate_m=_num(o, "ATE RMSE vs", "truth:"))))
    run("dist", ["dist"],
        lambda o: bar("1 device(s): gpu" in o and "dist-BA 64 landmarks on 1 dev" in o, "dist",
                      dict(ba_cost=_num(o, "  dist-BA", "->"))))
    for tag, r in runs.items():
        if r["launches"]["sampler"] == 0 or (tag != "dist" and r["launches"]["matcher"] == 0):
            raise AssertionError(f"cli {tag} launches {r['launches']}")
    return runs


DISK_TUM_FRAMES = 12       # cli.py slam's default synthetic sequence
DISK_KITTI_FRAMES = 16


def disk_path(workdir: str) -> dict:
    """Phase 26: a TUM folder (8-bit RGB and 16-bit depth PNGs,
    associations, ground truth) and a KITTI folder (image_0/1, calib,
    poses) at 480x640, written by the port's PNG writer, through `slam
    --tum`, `odo --kitti` and `stereo --kitti` with ATE held; the decoder
    that ran and its decode rate."""
    import os

    from cusift_tpu_torch.data.disk import write_kitti, write_tum
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, two_plane_stereo_sequence
    from cusift_tpu_torch.utils import native_loader

    seq = planar_rgbd_sequence(n_frames=DISK_TUM_FRAMES, h=480, w=640, seed=0, motion_scale=0.8)
    tum_dir = write_tum(workdir, seq.images, seq.depths, seq.poses_r, seq.poses_t, seq.timestamps)
    st = two_plane_stereo_sequence(n_frames=DISK_KITTI_FRAMES, h=480, w=640, seed=4,
                                   motion_scale=0.7, amplitude=2.0, baseline=0.12)
    kitti_dir, pose_file = write_kitti(workdir, st.images_l, st.intr, st.poses_r, st.poses_t,
                                       images_r=st.images_r, baseline=st.baseline)

    # decode rate of the RGB files, in this process, with the decoder the CLI takes
    rgb = sorted(os.path.join(tum_dir, "rgb", f) for f in os.listdir(os.path.join(tum_dir, "rgb")))
    nbytes_in = sum(os.path.getsize(p) for p in rgb)
    decoder = native_loader.decoder()
    rates = {}
    for name in dict.fromkeys((decoder, "numpy")):      # the CLI's decoder, then numpy's
        t0 = time.perf_counter()
        imgs = list(native_loader.FrameStream(rgb, backend=name))
        secs = time.perf_counter() - t0
        rates[name] = nbytes_in / 1e6 / secs
        log("disk", decoder=name, files=len(rgb), file_mb=f"{nbytes_in / 1e6:.3f}",
            decode_mb_per_s=f"{rates[name]:.3f}",
            mpix_per_s=f"{sum(i.size for i in imgs) / 1e6 / secs:.3f}",
            ms_per_frame=f"{secs * 1e3 / len(rgb):.3f}", card=json.dumps(smi_line()))

    runs = {}
    path = _path_len(st.poses_r, st.poses_t)
    for tag, args, key, bound in (
            ("slam --tum", ["slam", "--tum", tum_dir], ("ATE RMSE", "ATE RMSE"), MAX_ATE),
            ("odo --kitti", ["odo", "--kitti", kitti_dir, "--poses", pose_file],
             ("ATE RMSE (Sim3", "aligned)"), VO_ATE_OF_PATH * path),
            ("stereo --kitti", ["stereo", "--kitti", kitti_dir, "--poses", pose_file],
             ("metric ATE RMSE", "RMSE"), STEREO_ATE_OF_PATH * path)):
        out, secs, counts = _cli(args, tag)
        ate = _num(out, *key)
        ran = next(l for l in out.splitlines() if l.startswith("decoder: ")).split(": ")[1]
        if not ate < bound or ran != decoder or counts["sampler"] == 0 or counts["matcher"] == 0:
            raise AssertionError(f"disk {tag}: ATE {ate} (bound {bound}), decoder {ran}, "
                                 f"launches {counts}")
        runs[tag] = dict(seconds=secs, launches=counts, ate=ate)
        log("disk", command=json.dumps(tag), decoder=ran, ate=f"{ate:.6f}",
            bound=f"{bound:.6f}", seconds=f"{secs:.3f}", launches=json.dumps(counts),
            card=json.dumps(smi_line()))
    return dict(runs=runs, decoder=decoder, decode_mb_per_s=rates)


def entry_path(dev) -> dict:
    """Phase 27: `entry.entry()` (the two-view step at 480x640, 1024
    keypoints) and `entry.dryrun_multichip(1)` on the one-rank NCCL group."""
    from cusift_tpu_torch import entry

    fn, args = entry.entry()
    reset_counts()
    t0 = time.perf_counter()
    h, inliers, count, matches = fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    if (not bool(torch.isfinite(h).all()) or h.device.type != "cuda" or int(count) == 0
            or launches["sampler"] == 0 or launches["matcher"] == 0):
        raise AssertionError(f"entry: H {h}, count {count}, launches {launches}")
    reset_counts()
    t0 = time.perf_counter()
    summary = entry.dryrun_multichip(1)
    dry_s = time.perf_counter() - t0
    dry = read_counts()
    if dry["sampler"] == 0 or dry["matcher"] == 0:
        raise AssertionError(f"dryrun_multichip(1) launches {dry}")
    log("entry", keypoints=int(count), matches=int(matches), inliers=int(inliers),
        seconds=f"{secs:.3f}", launches=json.dumps(launches), dryrun=json.dumps(summary),
        dryrun_s=f"{dry_s:.3f}", dryrun_launches=json.dumps(dry), card=json.dumps(smi_line()))
    return dict(entry=launches, dryrun=dry)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # without the rest of the repository this fails before any output
    from cusift_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log("device", name=json.dumps(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, smi=json.dumps(smi))

    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=_build.build_seconds, sources=",".join(_build.SOURCES))
    for line in _build.build_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    gen = np.random.default_rng(0)
    k1 = check_sampler(dev, gen)
    k2 = check_matcher(dev, gen)
    launches = main_path(dev)
    zero_probe(dev)
    imgs, h_true = bench_frames(dev)
    k3 = check_octave(dev, imgs)
    k4 = check_ori_hist(dev, gen)
    k5 = check_desc_raw(dev, gen)
    k6 = check_sep(dev, gen)
    batch = batched_fused_path(dev, imgs, h_true)
    sep = separable_path(dev)
    rgbd = rgbd_pair(dev)
    slam, slam_inputs, slam_stats = slam_path(dev)
    k1_slam = check_sampler_slam(dev, slam_inputs["k1"])
    k2_slam = check_matcher_slam(dev, slam_inputs["k2"])
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_slam["max_abs_err"])
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_slam["max_abs_err"])
    t0 = time.perf_counter()
    chunked = chunked_slam_path(dev, slam_stats)
    stereo_seq = stereo_scene()
    pair = stereo_pair(dev, stereo_seq)
    stereo = stereo_slam_path(dev, stereo_seq)
    log("phases 16-18", seconds=f"{time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    mono = mono_pair(dev, stereo_seq)
    vo = mono_vo_path(dev, stereo_seq)
    sfm = sfm_path(dev)
    k1_vo = check_sampler_slam(dev, vo["k1_in"], path="vo")
    k2_vo = check_matcher_vo(dev, vo["k2_in"])
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_vo["max_abs_err"])
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_vo["max_abs_err"])
    log("phases 19-22", seconds=f"{time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    dist_res = dist_path(dev)
    dslam = dist_slam_path(dev, slam_stats)
    log("phases 23-24", seconds=f"{time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    cli = cli_path()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    try:
        disk = disk_path(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ent = entry_path(dev)
    log("phases 25-27", seconds=f"{time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    mvo = map_vo_path(dev, stereo_seq, vo)
    k2_map = check_matcher_map(dev, mvo["k2_in"])
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_map["max_abs_err"])
    seg = check_segment(dev, {**mvo["segment_in"], **sfm["segment_in"], **vo["segment_in"]})
    log("phases 28-29", seconds=f"{time.perf_counter() - t0:.3f}")
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    new_paths = {
        key: dict(dist_solvers=dict(one_rank_nccl=dist_res["launches"][key],
                                    **{f"gloo_{n}_ranks": g["launches"][key]
                                       for n, g in dist_res["gloo"].items()}),
                  dist_solvers_path="distributed BA, window BA, pose graph (phase 23)",
                  dist_slam=dslam["launches"][key],
                  dist_slam_path="Slam(dist_ba=True), one NCCL rank (phase 24)",
                  cli={tag: r["launches"][key] for tag, r in cli.items()},
                  cli_path="python -m cusift_tpu_torch.cli, one process a command (phase 25)",
                  disk={tag: r["launches"][key] for tag, r in disk["runs"].items()},
                  disk_path="TUM/KITTI folders through the CLI (phase 26)",
                  entry=ent["entry"][key], dryrun_multichip_1=ent["dryrun"][key])
        for key in ("sampler", "matcher")}
    vo_launches = {
        key: dict(pair=mono["launches"][key], run=vo["launches"][key], frames=vo["frames"],
                  per_frame=vo[f"k{i}_per_frame"], per_event=vo[f"k{i}_per_event"],
                  events=vo["n_events"])
        for i, key in ((1, "sampler"), (2, "matcher"))}
    stereo_launches = {
        key: dict(pair=pair[key], per_frame_chunk1=stereo[1][f"k{i}_per_frame"],
                  per_frame_chunk8=stereo[CHUNK][f"k{i}_per_frame"],
                  chunk8_run=stereo[CHUNK]["launches"][key],
                  chunk8_frames=STEREO_CHUNK_FRAMES)
        for i, key in ((1, "sampler"), (2, "matcher"))}

    map_launches = {key: dict(run=mvo["launches"][key], frames=mvo["frames"],
                              per_frame=mvo[f"k{i}_per_frame"])
                    for i, key in ((1, "sampler"), (2, "matcher"))}
    seg_main = seg["calls"]["map refine 1"]
    src = "cusift_tpu_torch/csrc/"
    tpu = "cusift_tpu/ops/pallas/"
    kernels = [
        dict(name="sample_grad_patches", route="cuda", source=src + "sampler.cu",
             replaces=tpu + "sampler.py:588", path="two-view (phase 5)",
             launches=launches["sampler"], rgbd_pair_launches=rgbd["sampler"],
             slam_launches=slam["sampler"], slam_path="RGB-D SLAM (phase 14)",
             slam_frame=k1_slam, chunked_slam_launches=chunked["sampler"],
             stereo_launches=stereo_launches["sampler"],
             stereo_path="stereo SLAM (phase 18)", vo_launches=vo_launches["sampler"],
             vo_path="mono VO (phases 19-20)", vo_shape=k1_vo,
             sfm_launches={k: sfm[k]["sampler"] for k in ("rgbd", "mono")},
             new_path_launches=new_paths["sampler"], map_launches=map_launches["sampler"],
             map_path="map-anchored mono VO (phase 28)", **k1),
        dict(name="match_top2", route="cuda", source=src + "matcher.cu",
             replaces=tpu + "matcher.py:43", path="two-view (phase 5)",
             launches=launches["matcher"], rgbd_pair_launches=rgbd["matcher"],
             slam_launches=slam["matcher"], slam_path="RGB-D SLAM (phase 14)",
             slam_shape=k2_slam, chunked_slam_launches=chunked["matcher"],
             stereo_launches=stereo_launches["matcher"],
             stereo_path="stereo SLAM (phase 18)", vo_launches=vo_launches["matcher"],
             vo_path="mono VO (phases 19-20)", vo_shape=k2_vo,
             sfm_launches={k: sfm[k]["matcher"] for k in ("rgbd", "mono")},
             new_path_launches=new_paths["matcher"], map_launches=map_launches["matcher"],
             map_path="map-anchored mono VO (phase 28)", map_shape=k2_map, **k2),
        dict(name="fused_octave", route="cuda", source=src + "octave.cu",
             replaces=tpu + "octave.py:186", path="batched fused (phase 11)",
             launches=batch["octave"], **k3),
        dict(name="sample_ori_hist", route="cuda", source=src + "sampler.cu",
             replaces=tpu + "sampler.py:402", path="batched fused (phase 11)",
             launches=batch["ori_hist"], **k4),
        dict(name="sample_desc_raw", route="cuda", source=src + "sampler.cu",
             replaces=tpu + "sampler.py:457", path="batched fused (phase 11)",
             launches=batch["desc_raw"], **k5),
        dict(name="sample_grad_patches_sep", route="cuda", source=src + "sampler.cu",
             replaces=tpu + "sampler.py:517", path="separable two-view (phase 12)",
             launches=sep["sep"], **k6),
        # not a TPU kernel: the deterministic twin of the reference's XLA
        # scatter-adds; its JSON numbers are the landmark refinement's call
        dict(name="segment_sum", route="cuda", source=src + "segment.cu",
             replaces="none (XLA scatter-add: cusift_tpu/optim/ba.py:35, "
                      "cusift_tpu/models/monomap.py:236)",
             path="map-anchored mono VO (phase 28)", launches=mvo["launches"]["segment"],
             sfm_launches={k: sfm[k]["segment"] for k in ("rgbd", "mono")},
             vo_launches=vo["launches"]["segment"], max_abs_err=seg["max_abs_err"],
             **{k: seg_main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                         "bound_by")}, calls=seg["calls"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

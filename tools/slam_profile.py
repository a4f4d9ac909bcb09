"""Where the RGB-D SLAM loop's time goes on the GPU.

    PYTHONPATH=. python tools/slam_profile.py [--frames 48] [--trace out.json]
        [--turns dense,bare,bare,dense] [--no-profile]

Runs `chip_smoke.py` phase 14's configuration (`chip_smoke.slam_setup`:
the 480x640 planar orbit, 2048 keypoints, the default SlamConfig with the
loop-closing thresholds) after the same untimed warm-up, twice:

  1. timed through Slam's hooks only (`chip_smoke.observe`): frames/s,
     and per part the host milliseconds of the tracking steps, the
     keyframe events' device spans and the graph solves that accepted
     closures run; once for each scene of --turns, in that order
     ("dense": phase 14's textured orbit, "bare": the same orbit on the
     reference's texture, which fills under a tenth of the keypoint
     slots), so that scenes compare within one call;
  2. under `torch.profiler` (CPU and CUDA activities), on the first
     scene of --turns, unless --no-profile: the device's busy share (the
     union of kernel intervals over the profiled wall time), the kernels
     by device time, and the aten operators by count.

The profiler slows the host's dispatch, so the frames/s of pass 2 is not
pass 1's.  Prints one line per part and, last, one JSON object.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

import chip_smoke as cs

# pass 1's scenes: phase 14's orbit, and the same orbit on the reference's
# texture (no detail bands)
SCENES = {"dense": cs.SLAM_SCENE,
          "bare": {k: v for k, v in cs.SLAM_SCENE.items()
                   if k not in ("detail", "detail_octaves")}}


def _busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3                                   # us -> ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=cs.SLAM_FRAMES)
    ap.add_argument("--trace", default=None, help="chrome trace of pass 2")
    ap.add_argument("--turns", default="dense",
                    help="comma-separated scenes of pass 1, in order: dense, bare")
    ap.add_argument("--no-profile", action="store_true", help="skip pass 2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("slam_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    turns = args.turns.split(",")
    scenes = {name: cs.slam_setup(args.frames, scene)[1:]
              for name, scene in SCENES.items() if name in turns}
    frames, build = scenes[turns[0]]
    build(dev).run(iter(frames[:cs.WARMUP_FRAMES]))
    torch.cuda.synchronize()
    out = dict(card=cs.smi_line(), frames=args.frames, pass1=[])

    for name in turns:
        frames, build = scenes[name]
        slam = build(dev)
        st = cs.observe(slam)
        t0 = time.perf_counter()
        recs = slam.run(iter(frames))
        t_end = time.perf_counter()
        marks = st["frame_end"]
        frame_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        ev_ms = [e["marks"][0].elapsed_time(e["marks"][1]) for e in st["events"]]
        solve_ms = [a["apply_ms"] for a in st["applied"] if a["accept"]]
        row = dict(
            scene=name, kpts_median=statistics.median(r["kpts"] for r in recs),
            keyframes=slam.state.n_kf_total, wall_s=t_end - t0,
            fps_after_first=(args.frames - 1) / (t_end - marks[0]),
            frame_ms_sum=sum(frame_ms), frame_ms_median=statistics.median(frame_ms),
            events=len(ev_ms), event_device_ms_sum=sum(ev_ms),
            event_device_ms_median=statistics.median(ev_ms) if ev_ms else None,
            closing_solves=len(solve_ms), closing_solve_ms_sum=sum(solve_ms),
            closing_solve_ms_median=statistics.median(solve_ms) if solve_ms else None)
        out["pass1"].append(row)
        cs.log("profile", pass_=1, **{k: (f"{v:.3f}" if isinstance(v, float) else v)
                                      for k, v in row.items()})
    if args.no_profile:
        print(json.dumps(out))
        return 0

    frames, build = scenes[turns[0]]
    slam = build(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        slam.run(iter(frames))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = _busy_ms(prof.events())
    busy_from = "union of kernel intervals"
    if busy == 0.0:       # no device events in the list: sum the kernel times
        busy = sum(k.self_device_time_total for k in prof.key_averages()) / 1e3
        busy_from = "sum of self device times"
    timed = [k for k in prof.key_averages() if k.device_time_total > 0]
    cuda = torch.autograd.DeviceType.CUDA
    on_card = [k for k in timed if getattr(k, "device_type", None) == cuda]
    kernels = sorted(((k.key, k.device_time_total / 1e3, k.count) for k in on_card or timed),
                     key=lambda x: -x[1])
    ops = sorted(((k.key, k.count) for k in prof.key_averages() if k.key.startswith("aten::")),
                 key=lambda x: -x[1])
    out["pass2"] = dict(wall_ms=wall_ms, device_busy_ms=busy, busy_share=busy / wall_ms,
                        busy_from=busy_from,
                        top_device=[dict(name=n[:80], ms=m, count=c) for n, m, c in kernels[:12]],
                        top_ops=[dict(name=n, count=c) for n, c in ops[:12]],
                        aten_ops=sum(c for _, c in ops))
    cs.log("profile", pass_=2, wall_ms=f"{wall_ms:.1f}", device_busy_ms=f"{busy:.1f}",
           busy_share=f"{busy / wall_ms:.4f}", busy_from=json.dumps(busy_from),
           aten_ops=out["pass2"]["aten_ops"])
    for row in out["pass2"]["top_device"]:
        cs.log("profile", kernel=json.dumps(row["name"]), ms=f"{row['ms']:.3f}", count=row["count"])
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

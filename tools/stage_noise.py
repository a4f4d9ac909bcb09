"""Two of `scripts/stage_times.py`'s programs timed in alternation on one
GPU, to tell the host's noise from their cost.

    PYTHONPATH=. python tools/stage_noise.py [--batch 16] [--stages ori,desc,full]

Builds stage_times' programs (`stage_times.setup`: its configuration and
scene at its defaults, with --batch) and times each
named stage with its queued method (a warm call, 10 queued calls, one
wait) three times in three orders, with Python's garbage collector on and
then off; each line has the host's enqueue time beside the total and the
CUDA segments the caching allocator allocated or freed meanwhile.  Then
it profiles 3 calls of each stage with `torch.profiler` and prints the
host time of each stage's calls, the device time under it and the device's
busy share (device time over host time: the programs are host-bound, so
the host time is the wall time).  Prints one JSON object last.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--stages", default="ori,desc,full")
    a = ap.parse_args()

    import torch

    from cusift_tpu_torch.scripts import stage_times

    names = a.stages.split(",")
    imgs, progs = stage_times.setup(
        stage_times.parse_args(["--batch", str(a.batch), "--stages", a.stages]),
        torch.device("cuda"))
    progs = {n: progs[n] for n in names}
    for p in progs.values():
        float(p(imgs))

    def timed(fn, iters=10):
        float(fn(imgs))
        m0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(imgs)
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        float(out)
        total = time.perf_counter() - t0
        m1 = torch.cuda.memory_stats()
        return dict(ms=total / iters * 1e3, enqueue_ms=enqueue / iters * 1e3,
                    mallocs=m1["segment.all.allocated"] - m0["segment.all.allocated"],
                    frees=m1["segment.all.freed"] - m0["segment.all.freed"])

    samples = {n: [] for n in names}
    for collect in (True, False):
        if not collect:
            gc.disable()
        for order in (names, names[::-1], names[1:] + names[:1]):
            for n in order:
                rec = timed(progs[n])
                samples[n].append(rec["ms"])
                print(json.dumps(dict(gc=collect, stage=n, **{k: round(v, 3) for k, v in
                                                               rec.items()})), flush=True)
        gc.enable()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    host, device = {}, {}
    for n in names:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                out = progs[n](imgs)
            torch.cuda.synchronize()
            float(out)
            host[n] = (time.perf_counter() - t0) / 3 * 1e3
        device[n] = sum(e.self_device_time_total for e in prof.key_averages()) / 3 / 1e3
    print(json.dumps(dict(
        card=torch.cuda.get_device_name(0), batch=a.batch,
        min_ms={n: round(min(v), 3) for n, v in samples.items()},
        max_ms={n: round(max(v), 3) for n, v in samples.items()},
        profiled_host_ms={n: round(v, 3) for n, v in host.items()},
        profiled_device_ms={n: round(v, 3) for n, v in device.items()},
        device_busy={n: round(device[n] / host[n], 4) for n in names})))


if __name__ == "__main__":
    main()

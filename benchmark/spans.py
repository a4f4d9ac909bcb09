"""The program's own spans in a cell: where its host time goes, which span
launched the device's work, and which span the host was in when the device
went idle.

    python3 -m benchmark.spans --threads 4 --workload <name> --seed <n> \
        [--cost-seconds 20]

From the root of a checkout, on a machine with the cell's GPU.  After the
cell's set-up (as `benchmark.run` makes it) it runs the cell's traced work
(`traced_work`: graf-batch8's `trace_calls` calls, a whole SLAM pass)
twice:

1. under `cusift_tpu_torch.utils.trace.recording()` and no profiler: the
   host time of every program span, without the profiler's per-operator
   cost, and the program's counters over that work;
2. under `torch.profiler`: the device's busy time of the operations each
   program span launched (a kernel, copy or fill is put down to the spans
   its launch, a CUDA runtime call found by correlation id, lies in, on the
   thread that opened the window; the feeder's copies, told apart by their
   stream, to none), and the longest idle gaps, each named
   `<benchmark span>/<innermost program span>` on that thread.

With `--cost-seconds`, it then measures what recording costs: the cell's
window (`window`, as `--trace 0` runs it) in turns without and with a
recording active, in turns: off, on, on, off.

The per-layer readers in `metrics/` that read the program's spans
(`extract_host_ms`, `extract_device_ms`, `ransac_host_ms`, `fetch_wait_ms`,
`feed_wait_ms`, `event_dispatch_ms`) take `layer_data`'s keys.  The last
line of standard output is one JSON object with their readings, the span
totals, the device time a span, the named gaps and the cost windows.
`reduce` is a pure function of the profiler's events, for the tests.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

from .tracing import _merge, _span_at

ROOT = Path(__file__).resolve().parent.parent

# the program's span names (cusift_tpu_torch's `trace.span` calls)
PROGRAM_SPANS = frozenset({
    "sift.extract", "sift.pyramid", "sift.detect", "sift.orientation", "sift.describe",
    "sift.topk", "match", "ransac.homography", "ransac.rigid", "twoview.match_pair",
    "slam.init", "slam.chunk_step", "slam.commit", "slam.event.dispatch", "slam.event.apply",
    "slam.graph_solve", "slam.bootstrap", "fetch", "feed.wait", "feed.pack", "feed.pin",
    "feed.copy"})

# the metrics/ readers of these data, by the kind of cell (`layer_data`'s)
READERS = {"reg": ("extract_host_ms.reg", "extract_device_ms.reg", "ransac_host_ms.reg"),
           "slam": ("extract_host_ms.slam", "extract_device_ms.slam", "ransac_host_ms.slam",
                    "fetch_wait_ms.slam", "feed_wait_ms.slam", "event_dispatch_ms.slam")}


def _inside(times, spans):
    """Mask of `times` that lie inside any of the [start, end] `spans`."""
    if not spans or len(times) == 0:
        return np.zeros(len(times), bool)
    iv = np.array(sorted(spans), np.int64)
    # spans of one name on one thread nest or follow each other: merge them
    reach = np.maximum.accumulate(iv[:, 1])
    i = np.searchsorted(iv[:, 0], times, side="right") - 1
    ok = i >= 0
    return ok & (times <= reach[np.maximum(i, 0)])


def reduce(host, device, window_name="bench.window", program=PROGRAM_SPANS, top=10):
    """Put the device's work and idle gaps down to the program's spans.

    host: (start, end, name, thread, correlation) of the host events: the
    benchmark's spans (`bench.*`, the window among them), the program's
    spans (names in `program`), and the CUDA runtime calls that launch
    device work (correlation: the id their device operation carries).
    device: (start, end, name, thread, correlation) of the device's
    operations.  Only host events on the window's thread count.

    Returns (device seconds a program span name: the union of the
    operations launched inside any span of that name; idle gaps
    [[name, seconds], ...], longest first, at most `top`, named
    `<benchmark span>/<innermost program span>` at the gap's start, or
    the benchmark span's name alone where no program span was open).
    """
    win = [h for h in host if h[2] == window_name]
    if not win:
        return {}, []
    w0, w1, _, wt, _ = win[0]
    mine = [h for h in host if h[3] == wt]
    bench = sorted(((a, b, n) for a, b, n, _, _ in mine
                    if n.startswith("bench.") and n != window_name), key=lambda s: s[0])
    prog = sorted(((a, b, n) for a, b, n, _, _ in mine if n in program), key=lambda s: s[0])
    launch_at = {c: a for a, _, n, _, c in mine
                 if c and not n.startswith("bench.") and n not in program}
    ops = [(a, b, launch_at.get(c)) for a, b, _, _, c in device]
    launched = [(a, b, t) for a, b, t in ops if t is not None]
    t = np.array([x[2] for x in launched], np.int64)
    st = np.array([x[0] for x in launched], np.int64)
    en = np.array([x[1] for x in launched], np.int64)
    by_name = {}
    for a, b, n in prog:
        by_name.setdefault(n, []).append((a, b))
    dev_s = {}
    for n, spans in by_name.items():
        m = _inside(t, spans)
        dev_s[n] = sum(b - a for a, b in _merge(zip(st[m].tolist(), en[m].tolist()))) * 1e-9
    # the idle gaps of the window, as `tracing.profile` finds them
    clipped = [(max(a, w0), min(b, w1)) for a, b, _, _, _ in device if b > w0 and a < w1]
    gaps, prev = [], w0
    for a, b in _merge(clipped) + [(w1, w1)]:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[0])
    # `_span_at` names a span by what follows "bench.": give the program's that prefix
    prog = [(a, b, "bench." + n) for a, b, n in prog]
    return dev_s, [[_gap_name(bench, prog, at), g * 1e-9] for g, at in gaps[:top]]


def _gap_name(bench, prog, t) -> str:
    """`<benchmark span>/<program span>` innermost at t, as `tracing`'s
    `_span_at` names each ("host" where none is open), or the benchmark
    span alone where no program span is open."""
    name, p = _span_at(bench, t), _span_at(prog, t)
    return name if p == "host" else f"{name}/{p}"


def profile_spans(work, device):
    """Run `work()` under the profiler inside a `bench.window` span, wait
    for the device, and `reduce` what it recorded.  Returns (device
    seconds a program span, idle gaps, device operations, busy seconds,
    window seconds, launches found for device operations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            work()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host, dev_ev = [], []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev_ev.append(e)
        elif name.startswith("bench.") or name in PROGRAM_SPANS:
            host.append((e.start_ns(), e.end_ns(), name, e.start_thread_id(), 0))
        elif name.startswith("cu"):         # a CUDA runtime or driver call
            host.append((e.start_ns(), e.end_ns(), name, e.start_thread_id(),
                         e.correlation_id()))
    calls = {c for *_, c in host if c}
    # a device operation carries its launch's correlation id, or links to
    # it; its fourth field here is its stream
    dev = []
    for e in dev_ev:
        c = e.correlation_id()
        dev.append((e.start_ns(), e.end_ns(), e.name(), e.device_resource_id(),
                    c if c in calls else e.linked_correlation_id()))
    # the profiler gives every CUDA runtime call the window's thread, the
    # feeder's too: those are told apart by the feeder's side stream (any
    # stream but the one most operations run on), and belong to no span
    streams = collections.Counter(d[3] for d in dev).most_common(1)
    side = {c for _, _, _, st, c in dev if st != streams[0][0]} if streams else set()
    host = [(a, b, n, -1 if c in side else t, c) for a, b, n, t, c in host]
    win = [h for h in host if h[2] == "bench.window"]
    dev_s, gaps = reduce(host, dev)
    w0, w1 = (win[0][0], win[0][1]) if win else (0, 0)
    busy = sum(b - a for a, b in _merge([(max(a, w0), min(b, w1)) for a, b, *_ in dev
                                          if b > w0 and a < w1]))
    found = sum(1 for *_, c in dev if c in calls)
    return dev_s, gaps, len(dev), busy * 1e-9, (w1 - w0) * 1e-9, found


def layer_data(rec, dev_s, profiled_counts, device_ops) -> dict:
    """The readers' inputs: host ms and count of spans by name (of the
    recording pass's main thread, and `feed.*` of every thread), the
    counters over the recording pass, the device ms a span over the
    profiled pass, and the counters over that pass."""
    main = threading.get_ident()
    host, count = {}, {}
    for s in rec.spans:
        if s.end_ns < 0 or (s.thread != main and not s.name.startswith("feed.")):
            continue
        host[s.name] = host.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-6
        count[s.name] = count.get(s.name, 0) + 1
    return {"span_host_ms": host, "span_count": count, "counts": dict(rec.counts),
            "span_device_ms": {k: v * 1e3 for k, v in dev_s.items()},
            "profiled_counts": dict(profiled_counts), "device_ops": device_ops}


def per_frame(total_ms, frames):
    """total / frames, or None where either is missing or zero."""
    if not total_ms or not frames:
        return None
    return total_ms / frames


def _cost(drv, seconds: float) -> dict:
    """The cell's window off and on recording, in turns (off, on, on, off)."""
    from cusift_tpu_torch.utils import trace

    out = {"off": [], "on": []}
    for on in (False, True, True, False):
        if hasattr(drv, "passes"):
            drv.passes.clear()
        if on:
            with trace.recording():
                r = drv.window(seconds)
        else:
            r = drv.window(seconds)
        out["on" if on else "off"].append(r)
    return out


def measure(name: str, seed: int, device, root: Path = ROOT,
            cost_seconds: float = 0.0) -> dict:
    """Set the cell up, record and profile its traced work, and (with
    `cost_seconds`) time its window off and on recording; returns the
    result (tests call this on the CPU)."""
    import torch

    from cusift_tpu_torch.utils import trace

    from . import harness

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_start = time.perf_counter()
    cell = harness.load_cell(root, name, seed, device)
    drv = harness.driver(cell)
    try:
        drv.setup()
        wait()
        setup_s = time.perf_counter() - t_start
        with trace.recording() as rec:
            drv.traced_work()
            wait()
        before = trace.counters()
        dev_s, gaps, ops, busy, window, found = profile_spans(drv.traced_work, device)
        after = trace.counters()
        data = layer_data(rec, dev_s, {k: v - before.get(k, 0) for k, v in after.items()}, ops)
        metrics = {m: harness.reader(m, cell.base)(data)
                   for m in READERS[drv.layer_data()["kind"]]}
        cost = _cost(drv, cost_seconds) if cost_seconds else None
    finally:
        if hasattr(drv, "close"):
            drv.close()
    return {"workload": name, "seed": seed, "setup_s": setup_s,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "metrics": metrics, "busy_s": busy, "window_s": window, "device_ops": ops,
            "ops_with_launch": found, "idle_gaps": gaps, "cost": cost, **data}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.spans",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--cost-seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    from .run import pin_host

    pin_host(args.threads, ROOT)
    import torch

    torch.set_num_threads(args.threads)
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, torch.device("cuda"), ROOT, args.cost_seconds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

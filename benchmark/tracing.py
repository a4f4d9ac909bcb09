"""The traced run's profile: `torch.profiler` around a fixed piece of work.

From the profiler's events it keeps the device's operations (kernels,
copies and fills) and the benchmark's own host spans (`bench.*`), both on
the profiler's clock, and reduces them to what the per-layer readers and
the result line need: the device's busy time (the union of its
operations), the traced window, the operations by total time and the
longest idle gaps, each named by the innermost benchmark span the host
was in when the gap opened.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch


class Profile(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: int
    top_ops: list          # [[name, seconds], ...] by total time, at most 10
    idle_gaps: list        # [[span name, seconds], ...] longest first, at most 10
    host_s: float          # the window on the host's clock


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile(work, device: torch.device) -> Profile:
    """Run `work()` under the profiler, wait for the device, and reduce."""
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.window"):
            work()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        host_s = time.perf_counter() - t0
    dev_ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("bench."):
            # the spans show on the device's timeline too: keep the host's
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            dev_ops.append((e.start_ns(), e.end_ns(), e.name()))
    win = [s for s in spans if s[2] == "bench.window"]
    w0, w1 = (win[0][0], win[0][1]) if win else (0, 0)
    busy_iv = _merge([[max(a, w0), min(b, w1)] for a, b, _ in dev_ops if b > w0 and a < w1])
    busy = sum(b - a for a, b in busy_iv)
    by_name = {}
    for a, b, n in dev_ops:
        by_name[n] = by_name.get(n, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, prev = [], w0
    inner = sorted((s for s in spans if s[2] != "bench.window"), key=lambda s: s[0])
    for a, b in busy_iv + [[w1, w1]]:
        if a > prev:
            gaps.append((a - prev, _span_at(inner, prev)))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[0])
    return Profile(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device_ops=len(dev_ops),
                   top_ops=[[n[:96], v * 1e-9] for n, v in top],
                   idle_gaps=[[name, g * 1e-9] for g, name in gaps[:10]], host_s=host_s)


def _span_at(spans, t) -> str:
    """The innermost (latest-starting) benchmark span open at time t."""
    best = None
    for a, b, n in spans:
        if a > t:
            break
        if b >= t:
            best = n
    return best[len("bench."):] if best else "host"

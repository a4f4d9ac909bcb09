"""The program's spans as the benchmark reads them (`benchmark/spans.py`):
the reduction of the profiler's events to device time a span and named
idle gaps, on synthetic events, and a tiny run of both cells on the CPU
that reads every span metric; the off/on order of the cost windows."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from benchmark.spans import READERS, _cost, measure, reduce

SEED = 2 ** 31 + 777


def _events():
    """A window on thread 1 with one benchmark call holding two program
    spans, a feeder span on thread 2 over the same time, and five device
    operations, each tied to its launch by correlation id."""
    main, feeder = 1, 2
    host = [
        (0, 1000, "bench.window", main, 0),
        (10, 900, "bench.call", main, 0),
        (20, 300, "sift.extract", main, 0),
        (40, 100, "sift.detect", main, 0),
        (400, 800, "ransac.homography", main, 0),
        (0, 1000, "feed.pack", feeder, 0),            # the feeder's: never names a gap
        # launches: (start, end, runtime call, thread, correlation)
        (50, 55, "cudaLaunchKernel", main, 11),
        (200, 205, "cudaLaunchKernel", main, 12),
        (450, 455, "cudaLaunchKernel", main, 13),
        (460, 465, "cudaLaunchKernel", main, 14),
        (600, 605, "cudaMemcpyAsync", feeder, 15),     # a feeder copy
    ]
    device = [
        (100, 150, "k_detect", 0, 11),
        (250, 350, "k_describe", 0, 12),
        (500, 520, "k_score", 0, 13),
        (510, 540, "k_irls", 0, 14),
        (610, 640, "memcpy", 0, 15),
    ]
    return host, device


def test_reduce_puts_device_time_under_the_launching_span():
    host, device = _events()
    dev_s, _ = reduce(host, device)
    ns = {k: round(v * 1e9) for k, v in dev_s.items()}
    # sift.extract launched k_detect and k_describe (50 + 100), its child
    # sift.detect k_detect only; the RANSAC two overlapping kernels (union
    # 500-540); the feeder's copy lies in no span of the window's thread
    assert ns == {"sift.extract": 150, "sift.detect": 50, "ransac.homography": 40}


def test_reduce_names_gaps_by_benchmark_and_program_span():
    host, device = _events()
    _, gaps = reduce(host, device)
    # the device is busy 100-150, 250-350, 500-540 and 610-640 (the
    # feeder's copy counts as busy); each gap takes the spans open on the
    # window's thread where it starts, the feeder's `feed.pack` none
    assert [(name, round(s * 1e9)) for name, s in gaps] == [
        ("call/ransac.homography", 360), ("call", 150), ("host", 100),
        ("call/sift.extract", 100), ("call/ransac.homography", 70)]


def test_reduce_without_window_is_empty():
    host, device = _events()
    assert reduce(host[1:], device) == ({}, [])


def test_cost_windows_alternate_off_and_on():
    from cusift_tpu_torch.utils import trace

    class Driver:                       # each window clears the passes before it
        passes, seen = [], []

        def window(self, seconds):
            assert not self.passes
            self.passes.append(seconds)
            self.seen.append(trace._active is not None)
            return len(self.seen)

    drv = Driver()
    assert _cost(drv, 0.5) == {"off": [1, 4], "on": [2, 3]}
    assert drv.seen == [False, True, True, False]


@pytest.mark.parametrize("cell", ["graf-batch8", "tum-xyz-offline"])
def test_tiny_cell_reads_every_span_metric(tiny, cell):
    r = measure(cell, SEED, torch.device("cpu"), tiny)
    kind = "reg" if cell.startswith("graf") else "slam"
    assert set(r["metrics"]) == set(READERS[kind])
    for m, v in r["metrics"].items():
        if m.startswith("extract_device_ms"):
            assert v is None            # no device operation ran
        else:
            assert v is not None and v > 0, m
    assert r["device_ops"] == 0 and not any(r["span_device_ms"].values())
    counts = r["counts"]
    if kind == "reg":
        tr = harness.load_cell(tiny, cell, SEED, torch.device("cpu")).traffic
        calls, views = tr["trace_calls"], tr["views_per_call"]
        assert counts["sift.frames"] == calls * (views + 1)
        assert counts["ransac.frames"] == r["span_count"]["ransac.homography"] == calls * views
    else:
        assert counts["slam.frames"] == r["span_count"]["slam.commit"] + 1
        assert counts["slam.events"] == r["span_count"]["slam.event.dispatch"] > 0
    # the benchmark's own traced run reads what it read before
    old = run_cell(cell, SEED, 30.0, True, "cpu", tiny)
    c = harness.load_cell(tiny, cell, SEED, torch.device("cpu"))
    assert set(old["metrics"]) == ({"event_ms.slam", "keyframes_per_pass.slam"}
                                   if kind == "slam" else set())
    assert set(old["metrics"]) <= set(harness.per_layer_names(c)) and old["correct"]

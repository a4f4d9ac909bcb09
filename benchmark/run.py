"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --threads 4 --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's GPUs.  Set-up
(`setup_s`, from the start of this process) makes the cell's inputs from
the seed on the card and warms up every shape the cell uses; then either
the measured window of `--seconds` (`--trace 0`: the cell's end-to-end
metrics) or one fixed piece of the cell's work under `torch.profiler`
(`--trace 1`: its per-layer metrics, the device's busy time and the
breakdown).  After the window the device's peak memory is read, the
program's state is dropped, and the outputs the window produced are
judged against the plain reference (`check.py`).  The last line of
standard output is the result, whose `check` key (last) gives each
compared number beside its limit; the same lines end standard error.

Without a GPU, or with fewer than the cell asks for, the run prints no
result and exits 2.  If a module of the JAX stack or of the JAX package
is loaded once the window has closed, it exits 3.  Build and kernel caches
stay in fixed directories inside the checkout.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--threads", type=int, default=4,
                    help="host threads of torch and the BLAS libraries")
    return ap.parse_args(argv)


def pin_host(threads: int, root: Path) -> None:
    """Host thread counts and cache directories, before torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(threads)
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, t_start: float | None = None) -> dict:
    """One run of a cell; returns the result (tests call this on the CPU)."""
    import torch

    from . import check, harness, tracing

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell = harness.load_cell(root, name, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    drv = harness.driver(cell)
    try:
        drv.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # what set-up made lives to the end: keep it out of the collector's scans
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start

        result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
        if trace:
            if hasattr(drv, "before_trace"):
                drv.before_trace()
            prof = tracing.profile(drv.traced_work, dev)
            data = dict(drv.layer_data(), busy_s=prof.busy_s, window_s=prof.window_s,
                        device_ops=prof.device_ops)
            for m in harness.per_layer_names(cell):
                v = harness.reader(m, cell.base)(data)
                if v is not None:
                    result["metrics"][m] = {"value": v, "unit": harness.unit_of(cell, m)}
        else:
            e2e = drv.window(seconds)
            e2e["setup_s"] = setup_s
            for m in harness.end_to_end_names(cell):
                result["metrics"][m] = {"value": e2e[m], "unit": harness.unit_of(cell, m)}
        gc.unfreeze()
        result["attempted"] = drv.attempted
        gpu = dev.type == "cuda"
        peak = torch.cuda.max_memory_allocated(dev) if gpu else 0
        result["device"] = {"platform": "gpu" if gpu else "cpu",
                            "kind": torch.cuda.get_device_name(dev) if gpu else "cpu", "count": 1,
                            "memory_peak_bytes": int(peak)}
        if trace:
            result["device"].update(busy_s=prof.busy_s, window_s=prof.window_s)
            result["breakdown"] = {"device_ops": prof.top_ops, "idle_gaps": prof.idle_gaps}

        drv.release()
        tally = drv.judge(control=False)
        truth = drv.truth()
    finally:
        gc.unfreeze()
        if hasattr(drv, "close"):      # undo the driver's recorders
            drv.close()
    result["correct"] = check.verdict(tally, cell.limits)
    result["check"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in tally.values.items()}
    result["check_items"] = tally.items
    result["check_expected"] = tally.expected
    result["check_unjudged"] = tally.unjudged
    result["truth"] = truth
    # the compared numbers come last
    result["check"] = result.pop("check")
    return result


def main(argv=None) -> int:
    args = parse(argv)
    t_start = time.perf_counter()
    pin_host(args.threads, ROOT)
    import torch

    torch.set_num_threads(args.threads)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      ROOT, t_start)
    from .harness import forbidden_modules

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

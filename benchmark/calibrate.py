"""Readings behind the correctness limits: the program's and the control's.

    python3 -m benchmark.calibrate --workload <name> --seeds 11 12 ... \
        [--control 3] [--out calib.jsonl]

For each seed, in one process: the cell's set-up, its traced work (a fixed
piece of the window's work, without the profiler), and the check of what
that work produced, against the plain reference: the program's numbers.
For the first `--control` seeds also the control's: the reference in TF32
put in the program's place at the same keypoints and estimates
(`check.py`).  One JSON line a seed on standard output (and appended to
--out).  A limit goes above the largest program reading of a dozen seeds
or more and below the smallest control reading.  Needs a GPU, as a run
does; tests drive `readings` on the CPU at small sizes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from .run import ROOT, pin_host


def _quantiles(samples: dict) -> dict:
    """Median, 99th percentile, largest value and count of each gap."""
    import torch

    out = {}
    for k, v in samples.items():
        x = torch.cat(v)
        out[k] = [float(x.median()), float(torch.quantile(x, 0.99)), float(x.max()), x.numel()]
    return out


def readings(name: str, seed: int, control: bool, device: str = "cuda",
             root: Path = ROOT, warm: bool = True) -> dict:
    """One seed's program (and control) numbers for the cell."""
    import torch

    from . import harness

    cell = harness.load_cell(root, name, seed, torch.device(device))
    if not warm:
        cell.traffic.update(warmup_calls=0, warmup_passes=0)
    drv = harness.driver(cell)
    t0 = time.perf_counter()
    drv.setup()
    drv.traced_work()
    if hasattr(drv, "passes") and not drv.passes:
        raise RuntimeError("the traced pass did not finish")
    work_s = time.perf_counter() - t0
    drv.release()
    state = drv.draw.get_state()
    t0 = time.perf_counter()
    prog = drv.judge(False)
    judge_s = time.perf_counter() - t0
    out = {"workload": name, "seed": seed, "setup_and_work_s": work_s, "judge_s": judge_s,
           "items": prog.items, "expected": prog.expected, "unjudged": prog.unjudged,
           "program": prog.values, "truth": drv.truth(),
           "program_quantiles": _quantiles(prog.samples)}
    if control:
        drv.draw.set_state(state)
        ctl = drv.judge(True)
        out["control"] = ctl.values
        out["control_quantiles"] = _quantiles(ctl.samples)
    if hasattr(drv, "close"):
        drv.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    pin_host(args.threads, ROOT)
    import torch

    torch.set_num_threads(args.threads)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", file=sys.stderr)
    for i, seed in enumerate(args.seeds):
        r = readings(args.workload, seed, i < args.control, warm=i == 0)
        r["card"] = card
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

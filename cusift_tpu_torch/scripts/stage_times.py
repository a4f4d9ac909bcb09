"""Per-stage timing of the port's batched extract pipeline on one GPU (the
twin of `scripts/stage_times.py`, which times the JAX package on a TPU).

    python -m cusift_tpu_torch.scripts.stage_times [--batch 16] [--iters 30] [--device cpu]

Builds programs that run progressively more of the pipeline over a batch
of frames and prints the marginal cost of each stage: pyramid (the octave
planes), score (the extrema score), topk (the per-octave candidate
selection), detect (selection and refinement), ori (orientation
histograms and dominant orientations), desc (slot compaction and
descriptors), and full (`extract_batch` plus the batch's consecutive
`match` calls).  A stage line is `{"cum_ms", "marginal_ms", "compile_s"}`
(`compile_s`: the first call's seconds, the kernels' nvcc build included
when the library is not built yet); the last stdout line is
`{"per_frame_ms": ...}` of `full`.  The first stderr line is nvidia-smi's
name and power limit of the card.

The flags, defaults and configuration are the reference's (the bench's
scene, budgets (2048, 1024, 256, 96, 32), `desc_slot_factor=1.10`,
upscale), plus --device ("cuda" unless asked for "cpu"; without a GPU the
run stops with an error).  The batch is walked as `extract_batch` walks
it: one batched program, each stage over all frames at once (each kernel
launched once an octave and a use for the batch).  The reference's topk
stage takes `lax.approx_max_k`; the port has no approximate top-k, so its
stage takes `torch.topk` of the same k along each frame's row.  In eager
torch every operation a program is given runs, so the pyramid stage also
builds the extrema score (which XLA drops from the reference's program as
unused) and the score line's marginal is its reduction alone.  Each
program ends in one sum per kind of output over the octaves, so the stage
markers add a few operations a program, not a few an octave.

Timing: the reference's queue of `iters` calls, one wait for the device,
then a read of the result, after a warm call.  The stages are timed in
five passes, in turn and in reverse by turns, and each keeps its fastest
(as bench.py keeps the faster of its two batch passes): the host's
dispatch of small operations still holds the card back part of the time,
and passes of one program on a shared host differ by more than the
marginal cost of the cheaper stages; the host's delays only add, so the
fastest pass is the estimate (`tools/stage_noise.py` separates the noise
from the cost and reads the card's busy share).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import MatchConfig, SiftConfig
from ..data.synthetic import warped_pair
from ..models.sift import _octave_planes, extract_batch
from ..ops.describe import compact_slots, descriptors
from ..ops.detect import detect_from_score
from ..ops.match import match
from ..ops.orientation import dominant_orientations, orientation_histograms
from ..utils.device import card_line, entry_device, synchronize
from ..utils.precision import pin_f32

STAGES = ("pyramid", "score", "topk", "detect", "ori", "desc")
PASSES = 5      # timing passes over all the stages; each stage keeps its best


def _finite_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x)).sum()


def _marker(groups: list) -> torch.Tensor:
    """One number that depends on every tensor of `groups` (a list, an
    entry per octave, of same-kind tensors), in a few operations: the
    tensors of a kind concatenated and summed once, not once an octave."""
    return sum(_finite_sum(torch.cat([t.reshape(-1) for t in kind]).to(torch.float32))
               for kind in zip(*groups))


def upto(stage: str, cfg: SiftConfig):
    """A program over a [B, H, W] batch that runs the pipeline through
    `stage` and returns one number that depends on all of its work."""
    def run(imgs: torch.Tensor) -> torch.Tensor:
        pin_f32()
        planes = _octave_planes(imgs, cfg)
        if stage == "pyramid":
            return _marker([(samp, dog) for samp, dog, _ in planes])
        if stage == "score":
            return _marker([(score,) for _, _, score in planes])
        outs = []
        for oi, (samp, dog, score) in enumerate(planes):
            if stage == "topk":
                outs.append(torch.topk(score.flatten(1), cfg.kpt_budget(oi)))
                continue
            kps = detect_from_score(dog, score, oi, cfg)
            if stage == "detect":
                outs.append((kps.xo, kps.valid))
                continue
            hist = orientation_histograms(samp, kps, cfg, level_base=1)
            theta, ok = dominant_orientations(hist, cfg)
            if stage == "ori":
                outs.append((theta, ok))
                continue
            slots = compact_slots(kps, theta, ok, cfg.desc_slots(oi))
            outs.append(descriptors(samp, slots, cfg, level_base=1))
        return _marker(outs)

    return run


def full(cfg: SiftConfig, bsz: int):
    def run(imgs: torch.Tensor) -> torch.Tensor:
        f = extract_batch(imgs, cfg)
        ms = [match(f.desc[i], f.valid[i], f.desc[i + 1], f.valid[i + 1],
                    MatchConfig()).ok.sum()
              for i in range(bsz - 1)]
        return f.desc.sum() + torch.stack(ms).sum()

    return run


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m cusift_tpu_torch.scripts.stage_times",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--max-kpts", type=int, default=4096)
    ap.add_argument("--stages", default="", help="comma-separated subset (default: all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs (default: the GPU)")
    args = ap.parse_args(argv)
    if args.batch < 2:
        ap.error("--batch must be >= 2 (full matches consecutive frames)")
    return args


def setup(args: argparse.Namespace, dev: torch.device) -> tuple[torch.Tensor, dict]:
    """The [B, H, W] frames on `dev` and the program of each stage `args`
    names, in pipeline order with full last."""
    h, w = args.size
    # bench.py's headline config (scene-matched budgets, trimmed descriptor
    # slots), so the stage table explains the headline number
    cfg = SiftConfig(max_kpts=args.max_kpts, max_kpts_per_octave=args.max_kpts // 2,
                     octave_budgets=(2048, 1024, 256, 96, 32),
                     desc_slot_factor=1.10, upscale=True)
    bsz = args.batch
    frames = []
    for s in range((bsz + 1) // 2):
        a, b, _ = warped_pair(h, w, seed=s, blobs=800, detail=0.25, detail_octaves=4)
        frames.extend([a, b])
    imgs = torch.from_numpy(np.stack(frames[:bsz])).to(dev)
    stages = [st for st in STAGES if not args.stages or st in args.stages.split(",")]
    programs = {st: upto(st, cfg) for st in stages}
    programs["full"] = full(cfg, bsz)
    return imgs, programs


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = entry_device(args.device, "stage_times")
    print(card_line(dev), file=sys.stderr, flush=True)
    imgs, programs = setup(args, dev)
    bsz = args.batch

    def timed(fn, x):
        float(fn(x))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(x)
        synchronize(dev)
        float(out)
        return (time.perf_counter() - t0) / args.iters

    stages = list(programs)
    compile_s, best = {}, {}
    for st in stages:
        t0 = time.perf_counter()
        float(programs[st](imgs))
        compile_s[st] = time.perf_counter() - t0
    for k in range(PASSES):             # the stages in turn, in reverse, and so on
        for st in stages if k % 2 == 0 else stages[::-1]:
            dt = timed(programs[st], imgs)
            best[st] = min(best.get(st, dt), dt)
    prev = 0.0
    report = {}
    for st in stages:
        dt = best[st]
        report[st] = {"cum_ms": round(dt * 1e3, 2),
                      "marginal_ms": round((dt - prev) * 1e3, 2),
                      "compile_s": round(compile_s[st], 1)}
        prev = dt
        print(st, json.dumps(report[st]), flush=True)
    report["per_frame_ms"] = round(dt / bsz * 1e3, 3)
    print(json.dumps({"per_frame_ms": report["per_frame_ms"]}), flush=True)
    return report


if __name__ == "__main__":
    main()

"""One frame's SIFT extraction: its scale space (levels and DoG written
once, DoG read once for the extremum test, separable blurs of radius
ceil(4 sigma)) and its descriptor slots' orientation and descriptor
samples."""

from __future__ import annotations

import math

from . import F32_FLOPS, HBM_BYTES_S

ORI_SAMPLES = 144       # 12 x 12 grid
DESC_SAMPLES = 144
FLOPS_A_SAMPLE = 30     # bilinear gradient, magnitude, angle, two soft bins


def _budget(sift: dict, octave: int) -> int:
    if sift["octave_budgets"]:
        b = sift["octave_budgets"]
        n = b[min(octave, len(b) - 1)]
    else:
        n = sift["max_kpts_per_octave"]
        if sift["octave_budget_decay"]:
            n = max(min(32, n), n >> octave)
    return max(8, (n + 7) // 8 * 8)


def least_s(shape: dict) -> float:
    """shape: the frame's h and w and the configuration's sift."""
    h, w, sift = shape["h"], shape["w"], shape["sift"]
    s = sift["scales_per_octave"]
    sig = [sift["sigma0"] * 2.0 ** (i / s) for i in range(s + 3)]
    inc = [math.sqrt(sig[i] ** 2 - sig[i - 1] ** 2) for i in range(1, len(sig))]
    taps = sum(2 * max(1, math.ceil(4 * x)) + 1 for x in inc)
    hh, ww = (2 * h, 2 * w) if sift["upscale"] else (h, w)
    base = min(h, w) * (2 if sift["upscale"] else 1)
    n_oct = 1 if base < 16 else min(sift["num_octaves"], int(math.log2(base / 8.0)))
    total = (4.0 * h * w + (16.0 * hh * ww if sift["upscale"] else 0.0)) / HBM_BYTES_S
    for o in range(n_oct):
        px = (hh >> o) * (ww >> o)
        nbytes = 4.0 * px * ((s + 3) + 2 * (s + 2))
        flops = 4.0 * px * taps
        slots = max(8, (int(_budget(sift, o) * sift["desc_slot_factor"]) + 7) // 8 * 8)
        flops += slots * (ORI_SAMPLES + DESC_SAMPLES) * FLOPS_A_SAMPLE
        total += max(nbytes / HBM_BYTES_S, flops / F32_FLOPS)
    return total

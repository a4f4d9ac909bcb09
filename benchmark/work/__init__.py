"""The least time the card could take for the work of a cell, counted
from the cell's shapes, not from what any kernel does.

A piece of work is (kind, shape, count); the module `work/<kind>.py`
gives the least time of one, `least_s(shape)`, so a new kind of work is a
new file.  Each piece of work is bounded by the larger of its bytes over the card's
memory bandwidth and its operations over the peak of the unit that would
do them; the pieces add up.  Bytes count each input read once and each
output written once.  Peaks: NVIDIA's data sheet for one H100 SXM (dense):
3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores, 495
TFLOP/s in TF32 on them (the matcher's products).
"""

from __future__ import annotations

import importlib

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12


def least_time_s(work: list) -> float:
    """Sum over (kind, shape, count) pieces of work."""
    t = 0.0
    for kind, shape, count in work:
        if not kind.isidentifier():
            raise ValueError(f"unknown work {kind!r}")
        try:
            mod = importlib.import_module(f"{__name__}.{kind}")
        except ModuleNotFoundError as e:
            raise ValueError(f"unknown work {kind!r}") from e
        t += count * mod.least_s(shape)
    return t

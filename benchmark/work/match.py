"""One [n, 128] x [128, m] descriptor similarity and its top-2 (TF32
products on the tensor cores)."""

from __future__ import annotations

from . import HBM_BYTES_S, TF32_FLOPS


def least_s(shape: dict) -> float:
    n, m = shape["n"], shape["m"]
    return max(4.0 * 128 * (n + m) / HBM_BYTES_S, 2.0 * n * m * 128 / TF32_FLOPS)

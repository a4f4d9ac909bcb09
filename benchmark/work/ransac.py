"""One RANSAC fit (a homography or a rigid motion): scoring `hyp`
hypotheses on n correspondences, then `rounds` refits."""

from __future__ import annotations

from . import F32_FLOPS


def least_s(shape: dict) -> float:
    return (shape["hyp"] + shape["rounds"] + 1) * shape["n"] * 20.0 / F32_FLOPS

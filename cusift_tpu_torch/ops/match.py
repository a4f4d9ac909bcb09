"""Brute-force ratio-test descriptor matching (twin of `cusift_tpu/ops/match.py`).

The similarity + top-2 runs through kernel K2 (`kernels/matcher.py`), which
launches the CUDA kernel for a CUDA tensor and takes its plain torch
version for a CPU tensor; `backend="xla"` selects the plain version on any
device, as in the reference.  The reference's M <= 8192 guard was a VMEM
limit of the TPU kernel and has no counterpart here.

Either side may carry a leading frame axis, which replaces the reference's
`jax.vmap(match)`: a side without it is shared by every frame, and the
batch takes one K2 launch (two with `cross_check`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchConfig
from ..kernels import matcher as k2
from ..utils import trace
from ..utils.precision import pin_f32


class Matches(NamedTuple):
    """Per-row-of-A match results ([B, N] for a batch of frames)."""

    idx: torch.Tensor    # [N] int32 best match in B
    dist: torch.Tensor   # [N] L2 distance of best match
    score: torch.Tensor  # [N] best correlation (dot product)
    ratio: torch.Tensor  # [N] d1/d2 ambiguity
    ok: torch.Tensor     # [N] passed validity + ratio test (+ cross-check)


def match(desc_a: torch.Tensor, valid_a: torch.Tensor,
          desc_b: torch.Tensor, valid_b: torch.Tensor,
          cfg: MatchConfig = MatchConfig()) -> Matches:
    """Ratio-test matching of [N, 128] against [M, 128] unit descriptors.

    desc_a [B, N, 128] / valid_a [B, N] and desc_b [B, M, 128] / valid_b
    [B, M] match frame by frame; a side given without the B axis is
    matched against every frame of the other.  Row i of frame b equals
    the call on frame b alone, bit for bit.
    """
    frames = (desc_a.shape[0] if desc_a.ndim == 3 else desc_b.shape[0] if desc_b.ndim == 3
              else 1)
    with trace.span("match", frames=frames):
        return _match(desc_a, valid_a, desc_b, valid_b, cfg)


def _match(desc_a, valid_a, desc_b, valid_b, cfg: MatchConfig) -> Matches:
    pin_f32()
    if cfg.backend in ("auto", "pallas"):
        top2 = k2.top2
    elif cfg.backend == "xla":
        top2 = k2.top2_plain
    else:
        raise ValueError(f"unknown matcher backend {cfg.backend!r}")
    desc_a = desc_a.to(torch.float32).contiguous()
    desc_b = desc_b.to(torch.float32).contiguous()
    valid_a = valid_a.to(torch.bool).contiguous()
    valid_b = valid_b.to(torch.bool).contiguous()
    top, i1 = top2(desc_a, desc_b, valid_b)
    s1, s2 = top[..., 0], top[..., 1]

    # unit vectors: d^2 = 2 - 2 <a, b>.  Clamp the correlations first:
    # masked lanes carry -inf, and inf/inf in the ratio would be a NaN
    # even though the ok gate discards those lanes.
    d1 = torch.sqrt(torch.clamp(2.0 - 2.0 * s1.clamp(-1.0, 1.0), min=0.0))
    d2 = torch.sqrt(torch.clamp(2.0 - 2.0 * s2.clamp(-1.0, 1.0), min=1e-12))
    ratio = d1 / d2
    # isfinite(s2): with a single valid candidate the second-best is -inf
    # and the ratio test would pass vacuously
    ok = (valid_a & torch.isfinite(s1) & torch.isfinite(s2)
          & (ratio < cfg.ratio_thresh) & (s1 > cfg.min_score))
    if cfg.cross_check:
        _, best_for_b = top2(desc_b, desc_a, valid_a)
        rows = torch.arange(desc_a.shape[-2], device=desc_a.device)
        ok = ok & (torch.gather(best_for_b, -1, i1.long()) == rows)
    return Matches(idx=i1, dist=d1, score=s1, ratio=ratio, ok=ok)

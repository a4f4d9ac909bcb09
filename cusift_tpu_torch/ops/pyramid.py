"""Gaussian scale-space levels (twin of `cusift_tpu/ops/pyramid.py`).

Only the "chain" build (incremental blurs) is ported; the levels of an
octave are returned as a list of [H, W] tensors, as in the reference, or
of [B, H, W] tensors for a batch of frames.
"""

from __future__ import annotations

import torch

from ..config import SiftConfig
from .gaussian import blur, upsample2


def initial_level(img: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Octave-0 base of a [H, W] image or a [B, H, W] batch: optional 2x
    upsample + blur up to sigma0."""
    if img.ndim not in (2, 3):
        raise ValueError(f"a [H, W] image or a [B, H, W] batch, got {tuple(img.shape)}")
    img = img.to(torch.float32)
    if cfg.upscale:
        base = upsample2(img)
        assumed = cfg.init_blur * 2.0
    else:
        base = img
        assumed = cfg.init_blur
    delta = max(cfg.sigma0 ** 2 - assumed ** 2, 0.01) ** 0.5
    return blur(base, delta, backend=cfg.conv_backend)


def octave_levels(base: torch.Tensor, cfg: SiftConfig) -> list[torch.Tensor]:
    """All S+3 blur levels of one octave from its sigma0 base."""
    if cfg.pyramid_impl == "direct":
        raise NotImplementedError(
            "pyramid_impl='direct' is not ported (ROADMAP queue 1, slice 1 "
            "item 5: octave_levels_direct)")
    if cfg.pyramid_impl != "chain":
        raise ValueError(f"unknown pyramid_impl {cfg.pyramid_impl!r}")
    levels = [base]
    for s in cfg.incremental_sigmas():
        levels.append(blur(levels[-1], s, backend=cfg.conv_backend))
    return levels

"""Gaussian scale space and difference of Gaussians (twin of
`cusift_tpu/ops/pyramid.py`).

Two builds of an octave's levels, chosen by `SiftConfig.pyramid_impl`:
"chain" (incremental blurs, each level from the one before) and "direct"
(every level straight from the octave base, with cumulative-sigma taps
at a shared radius, as banded-matrix products).  The levels of an octave
are a list of [H, W] tensors, as in the reference, or of [B, H, W]
tensors for a batch of frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SiftConfig
from .gaussian import (_band_matrix, _conv1d_windows, blur, downsample2,
                       gaussian_taps, upsample2)


class Octave(NamedTuple):
    gauss: torch.Tensor  # [S+3, H, W] blurred levels
    dog: torch.Tensor    # [S+2, H, W] difference of Gaussians


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
        return octave_levels_direct(base, cfg)
    if cfg.pyramid_impl != "chain":
        raise ValueError(f"unknown pyramid_impl {cfg.pyramid_impl!r}")
    levels = [base]
    for s in cfg.incremental_sigmas():
        levels.append(blur(levels[-1], s, backend=cfg.conv_backend))
    return levels


def octave_levels_direct(base: torch.Tensor, cfg: SiftConfig,
                         block: int = 128) -> list[torch.Tensor]:
    """All S+3 levels of one octave, each non-base level straight from the
    base: one rows pass and one columns pass for all S+2 levels, against a
    [L, win, block] stack of banded operators (cumulative sigmas, a shared
    radius).  Gaussians compose, so the levels agree with the chain's to
    the taps' truncation."""
    sigmas, acc = [], 0.0
    for s in cfg.incremental_sigmas():
        acc = math.sqrt(acc * acc + s * s)
        sigmas.append(acc)
    rmax = max(1, int(math.ceil(4.0 * sigmas[-1])))
    tmats = torch.from_numpy(np.stack([_band_matrix(gaussian_taps(s, rmax), block)
                                       for s in sigmas])).to(base.device)
    rows = _conv1d_windows(base, tmats, rmax, -2, block)      # [L, ..., H, W]
    blurred = _conv1d_windows(rows, tmats, rmax, -1, block, batched_in=True)
    return [base] + list(blurred.unbind(0))


def build_pyramid(img: torch.Tensor, cfg: SiftConfig) -> list[Octave]:
    """The scale space of a [H, W] image in [0, 1]: one Octave per octave,
    finest first; octave o is (H >> o, W >> o) of the base image (twice
    the input's size with cfg.upscale)."""
    n_oct = cfg.num_octaves_for(*img.shape[-2:])
    octaves = []
    current = initial_level(img, cfg)
    for _ in range(n_oct):
        levels = octave_levels(current, cfg)
        gauss = torch.stack(levels)                       # [S+3, H, W]
        octaves.append(Octave(gauss=gauss, dog=gauss[1:] - gauss[:-1]))
        # the next octave's base: the level carrying 2 sigma0 (index S)
        current = downsample2(levels[cfg.scales_per_octave])
    return octaves

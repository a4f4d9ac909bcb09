"""K3: the fused octave (CUDA kernel `csrc/octave.cu`).

Replaces the TPU kernel `cusift_tpu/ops/pallas/octave.py:fused_octave`
(bodies `_kernel` and `_kernel_hbm`, shared `_compute`).  From an octave
base at sigma0 it computes every level straight from the base with the
total-sigma taps sqrt(sigma_i^2 - sigma_0^2) (the reference's `_plan`),
the S+2 DoG planes, and the 26-neighbour extrema score of DoG levels
1..S (|DoG| at prefiltered interior extrema, -inf elsewhere).  A [B, H, W]
base is one launch over all frames.  The TPU row tile, VMEM scratch and
manual output DMA have no meaning on the GPU and are not carried over.

What bounds it on the H100: the bytes of the 3S + 2 output planes; see the
source's header for the design.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
`fused_octave_plain`, the same direct-from-base formula in plain torch
(not the incremental chain), which is also what the tests and
`chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SiftConfig
from ..ops.detect import extrema_score
from ..ops.gaussian import blur, gaussian_taps
from . import _build

launches = 0   # kernel launches made by `fused_octave`

MAX_LEVELS = 8    # blurred levels S + 2 (csrc/octave.cu kMaxLevels)
MAX_RADIUS = 32   # largest tap radius (csrc/octave.cu kMaxRadius)


def level_sigmas(cfg: SiftConfig) -> list[float]:
    """Blur of levels 1..S+2 relative to the octave base (total sigma)."""
    sig = cfg.sigmas()
    return [math.sqrt(max(sig[i] ** 2 - sig[0] ** 2, 1e-12))
            for i in range(1, cfg.levels_per_octave)]


def fused_octave_plain(base: torch.Tensor, cfg: SiftConfig):
    """Plain torch version of K3 on a [H, W] or [B, H, W] base."""
    s = cfg.scales_per_octave
    levels = [base] + [blur(base, sd) for sd in level_sigmas(cfg)]
    gauss = torch.stack(levels, -3)                      # [..., S+3, H, W]
    dog = gauss[..., 1:, :, :] - gauss[..., :-1, :, :]
    return gauss[..., 1:s + 1, :, :], dog, extrema_score(dog, cfg)


@functools.cache
def _tap_table(sigmas: tuple, device: torch.device):
    """(taps [nlev, 2R+1] f32, radii [nlev] int32) on `device`, and R."""
    taps = [gaussian_taps(sd) for sd in sigmas]
    radii = [(t.shape[0] - 1) // 2 for t in taps]
    r = max(radii)
    table = np.zeros((len(taps), 2 * r + 1), np.float32)
    for i, t in enumerate(taps):
        table[i, :t.shape[0]] = t
    return (torch.from_numpy(table).to(device),
            torch.tensor(radii, dtype=torch.int32, device=device), r)


def fused_octave(base: torch.Tensor, cfg: SiftConfig):
    """K3: one octave from its base [H, W] or [B, H, W] (already at sigma0).

    Returns (sample_levels [(B,) S, H, W], dog [(B,) S+2, H, W],
    score [(B,) S, H, W]): Gaussian levels 1..S, all DoG planes, and |DoG|
    at interior 26-neighbour extrema that clear the contrast prefilter
    0.5 * cT / S, -inf elsewhere.  All float32, whatever `score_dtype` says,
    as in the reference's fused path.
    """
    global launches
    if base.device.type == "cpu":
        return fused_octave_plain(base, cfg)
    if base.device.type != "cuda":
        raise ValueError(f"fused_octave: no kernel for {base.device}")
    if base.dtype != torch.float32 or not base.is_contiguous() or base.ndim not in (2, 3):
        raise ValueError(f"fused_octave: base must be a contiguous float32 [H, W] or "
                         f"[B, H, W] tensor, got {base.dtype} {tuple(base.shape)}")
    s = cfg.scales_per_octave
    nlev = s + 2
    taps, radii, r = _tap_table(tuple(level_sigmas(cfg)), base.device)
    h, w = base.shape[-2:]
    pad = r + 1                       # +1: the extrema test needs a DoG halo
    if not 3 <= nlev <= MAX_LEVELS or r > MAX_RADIUS:
        raise ValueError(f"fused_octave: {nlev} levels of radius up to {r}; the "
                         f"kernel takes 3..{MAX_LEVELS} levels of radius <= {MAX_RADIUS}")
    if min(h, w) <= pad:
        # reflect padding needs pad < size; the callers' 64-px gate keeps it
        raise ValueError(f"fused_octave: a {h}x{w} octave is too small for a "
                         f"reflect pad of {pad}")
    frames = base.reshape(-1, 1, h, w)
    b = frames.shape[0]
    padded = F.pad(frames, (pad, pad, pad, pad), mode="reflect").contiguous()
    samp = torch.empty((b, s, h, w), dtype=torch.float32, device=base.device)
    dog = torch.empty((b, nlev, h, w), dtype=torch.float32, device=base.device)
    score = torch.empty_like(samp)
    prefilter = 0.5 * cfg.contrast_thresh / s
    lib = _build.library()
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cusift_fused_octave(
            padded.data_ptr(), samp.data_ptr(), dog.data_ptr(), score.data_ptr(),
            taps.data_ptr(), radii.data_ptr(), taps.shape[1], nlev, r, b, h, w,
            prefilter, stream)
    _build.check(err, "cusift_fused_octave")
    launches += 1
    if base.ndim == 2:
        return samp[0], dog[0], score[0]
    return samp, dog, score

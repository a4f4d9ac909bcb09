"""K3: the fused octave (CUDA kernel `csrc/octave.cu`).

Replaces the TPU kernel `cusift_tpu/ops/pallas/octave.py:fused_octave`
(bodies `_kernel` and `_kernel_hbm`, shared `_compute`).  From an octave
base at sigma0 it computes every level straight from the base with the
total-sigma taps sqrt(sigma_i^2 - sigma_0^2) (the reference's `_plan`),
the S+2 DoG planes, and the 26-neighbour extrema score of DoG levels
1..S (|DoG| at prefiltered interior extrema, -inf elsewhere).  A [B, H, W]
base is one launch over all frames.  The TPU row tile, VMEM scratch and
manual output DMA have no meaning on the GPU and are not carried over.

What bounds it on the H100: the bytes of the 3S + 2 output planes, and in
practice the shared-memory instructions of the blurs.  A block walks down
a band of rows of one frame's 64-column strip, streaming the base through
a window of rows in shared memory; both blur passes are register-blocked
8 outputs to a thread with symmetric taps paired.  `_launch_plan` sets the
geometry; see the source's header for the design.

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
from ..utils import trace
from . import _build


MAX_LEVELS = 8    # blurred levels S + 2 (csrc/octave.cu kMaxLevels)
MAX_RADIUS = 32   # largest tap radius (csrc/octave.cu kMaxRadius)

# csrc/octave.cu's geometry; `_launch_plan` sizes shared memory from it
STRIP = 64               # output columns per block (kStrip)
GROUP_ROWS = 8           # level rows per step down the band (kV)
WINDOW_STRIDE = STRIP + 2 + 2 * MAX_RADIUS   # window row stride (kRS)
LEV_STRIDE = 68          # kLS
LEV_ROWS = 10            # ring of blurred level rows (kLevRows)
BASE_ROWS = 24           # ring of level-0 rows (kBaseRows)
MAX_SMEM = 232_448       # bytes of shared memory a block may use on the H100
MAX_GROUPS = 16          # band of 8 * 16 - 2 = 126 rows at most
MIN_FRAME_BLOCKS = 48    # blocks per frame the band height aims for


def _launch_plan(b: int, h: int, w: int, nlev: int, r: int) -> dict:
    """Geometry of K3 for a [b, h, w] base with nlev levels of radius <= r.

    A block owns a STRIP-column strip and a band of `band_rows` output
    rows of one frame; it computes the 1-px level halo around them, so
    (band_rows + 2) / 8 groups of 8 level rows, from a window of 2r + 8
    base rows that moves down 8 rows per group inside a buffer of 2r + 16
    rows (shifted by 16 rows every second group).  Bands are as tall as
    MAX_GROUPS allows while a frame still gives MIN_FRAME_BLOCKS blocks;
    small octaves get short bands.  The row-blurred buffer's stride is 1
    mod 32 (conflict-free horizontal reads) and covers the window.
    Nothing but the grid depends on b, so each frame of a batch is
    computed exactly as it would be alone.
    """
    if not (b >= 1 and h >= 1 and w >= 1 and 3 <= nlev <= MAX_LEVELS
            and 0 <= r <= MAX_RADIUS):
        raise ValueError(f"fused_octave plan: b={b} h={h} w={w} nlev={nlev} r={r}")
    strips = -(-w // STRIP)
    for groups in range(MAX_GROUPS, 0, -1):
        band_rows = GROUP_ROWS * groups - 2
        bands = -(-h // band_rows)
        if strips * bands >= MIN_FRAME_BLOCKS:
            break
    window_rows = 2 * r + 2 * GROUP_ROWS
    vbuf_stride = 32 * -(-(STRIP + 2 + 2 * r - 1) // 32) + 1
    smem = 4 * (window_rows * WINDOW_STRIDE + nlev * GROUP_ROWS * vbuf_stride
                + (nlev * LEV_ROWS + BASE_ROWS) * LEV_STRIDE)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_octave plan: {smem} bytes of shared memory")
    return dict(strip=STRIP, strips=strips, band_rows=band_rows, bands=bands,
                groups=groups, window_rows=window_rows, vbuf_stride=vbuf_stride,
                smem_bytes=smem, grid=(strips, bands, b))


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
def _tap_table(sigmas: tuple):
    """Host (taps [nlev, R+1] f32, radii [nlev] int32) and R: row i holds
    level i's first r_i + 1 taps (the outer..inner pair taps, then the
    centre); the kernel takes them as a launch parameter."""
    taps = [gaussian_taps(sd) for sd in sigmas]
    radii = [(t.shape[0] - 1) // 2 for t in taps]
    r = max(radii)
    table = np.zeros((len(taps), r + 1), np.float32)
    for i, (t, ri) in enumerate(zip(taps, radii)):
        table[i, :ri + 1] = t[:ri + 1]
    return table, np.asarray(radii, np.int32), r


def fused_octave(base: torch.Tensor, cfg: SiftConfig):
    """K3: one octave from its base [H, W] or [B, H, W] (already at sigma0).

    Returns (sample_levels [(B,) S, H, W], dog [(B,) S+2, H, W],
    score [(B,) S, H, W]): Gaussian levels 1..S, all DoG planes, and |DoG|
    at interior 26-neighbour extrema that clear the contrast prefilter
    0.5 * cT / S, -inf elsewhere.  All float32, whatever `score_dtype` says,
    as in the reference's fused path.
    """
    if base.device.type == "cpu":
        return fused_octave_plain(base, cfg)
    if base.device.type != "cuda":
        raise ValueError(f"fused_octave: no kernel for {base.device}")
    if base.dtype != torch.float32 or not base.is_contiguous() or base.ndim not in (2, 3):
        raise ValueError(f"fused_octave: base must be a contiguous float32 [H, W] or "
                         f"[B, H, W] tensor, got {base.dtype} {tuple(base.shape)}")
    s = cfg.scales_per_octave
    nlev = s + 2
    taps, radii, r = _tap_table(tuple(level_sigmas(cfg)))
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
    plan = _launch_plan(b, h, w, nlev, r)
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
            taps.ctypes.data, radii.ctypes.data, nlev, r, b, h, w,
            plan["band_rows"], plan["window_rows"], plan["vbuf_stride"],
            plan["smem_bytes"], prefilter, stream)
    _build.check(err, "cusift_fused_octave")
    trace.count("kernel.octave")
    if base.ndim == 2:
        return samp[0], dog[0], score[0]
    return samp, dog, score

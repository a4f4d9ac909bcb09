"""End-to-end SIFT extraction (twin of `cusift_tpu/models/sift.py`).

Pyramid, detection, orientation, descriptors and compaction with static
capacities, as in the reference: the result is a `SiftFeatures` buffer of
`cfg.total_kpts` slots with a validity mask and zeroed dead lanes, so the
two packages' outputs compare slot by slot.

Kernels by configuration: `fused_pyramid="pallas"`/`"pallas_hbm"` builds
octaves of at least 64 px through K3 (smaller ones keep the chain);
orientation and descriptors sample through K1 by default, K4/K5 with
`sampler="fused"`, and K6/K1 with `sampler="separable"`.  `extract_batch`
is one batched program from the pyramid to the final top-k, as the
reference's `jax.vmap(extract)` is: every stage carries a leading frame
axis, and each kernel launches once an octave and a use for the whole
batch.  `extract` is the same code at B = 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SiftConfig
from ..kernels import octave as k3
from ..ops.describe import compact_slots, descriptors
from ..ops.detect import detect_from_score, extrema_score
from ..ops.gaussian import downsample2
from ..ops.keypoints import take, top_indices
from ..ops.orientation import dominant_orientations, orientation_histograms
from ..ops.pyramid import initial_level, octave_levels
from ..utils import trace
from ..utils.device import as_input
from ..utils.precision import pin_f32


class SiftFeatures(NamedTuple):
    """Static-capacity feature set: one row per (keypoint, orientation) slot
    ([B, N, ...] fields from `extract_batch`)."""

    x: torch.Tensor            # [N] base-image column
    y: torch.Tensor            # [N] base-image row
    sigma: torch.Tensor        # [N]
    orientation: torch.Tensor  # [N] radians
    response: torch.Tensor     # [N] DoG contrast
    edgeness: torch.Tensor     # [N]
    octave: torch.Tensor       # [N] int32
    desc: torch.Tensor         # [N, 128] L2-normalised
    valid: torch.Tensor        # [N] bool

    @property
    def count(self):
        return self.valid.sum()


def _features_from(slots, desc: torch.Tensor, slot_valid: torch.Tensor) -> SiftFeatures:
    return SiftFeatures(
        x=slots.x, y=slots.y, sigma=slots.sigma, orientation=slots.theta,
        response=slots.response, edgeness=slots.edgeness,
        octave=slots.octave, desc=desc, valid=slot_valid,
    )


def _topk(feats: SiftFeatures, n: int) -> SiftFeatures:
    """Each frame's n best valid slots of [B, M, ...] features, dead lanes
    zeroed."""
    if feats.valid.shape[1] < n:  # pad up to the static output capacity
        pad = n - feats.valid.shape[1]
        feats = SiftFeatures(*(
            torch.cat([a, a.new_zeros(a.shape[:1] + (pad,) + a.shape[2:])], 1)
            for a in feats))
    score = torch.where(feats.valid, feats.response.abs(),
                        torch.full_like(feats.response, -torch.inf))
    idx = top_indices(score, n)
    out = take(feats, idx)
    valid = out.valid & torch.isfinite(score.gather(-1, idx))
    # zero every field of dead lanes: invalid-slot content depends on the
    # top-k tie order and must never leak downstream
    out = SiftFeatures(*(
        torch.where(valid.reshape(valid.shape + (1,) * (a.ndim - 2)), a,
                    torch.zeros_like(a)) for a in out))
    return out._replace(valid=valid)


@trace.traced("sift.pyramid")
def _octave_planes(img: torch.Tensor, cfg: SiftConfig):
    """Per octave: (sample_levels [..., S, H, W], dog [..., S+2, H, W],
    score [..., S, H, W]) of a [H, W] image or a [B, H, W] batch."""
    if cfg.fused_pyramid not in ("auto", "xla", "pallas", "pallas_hbm"):
        raise ValueError(f"unknown fused_pyramid {cfg.fused_pyramid!r}")
    # the TPU's two fused forms differ only in how outputs leave VMEM
    fused = cfg.fused_pyramid in ("pallas", "pallas_hbm")
    s_ = cfg.scales_per_octave
    n_oct = cfg.num_octaves_for(*img.shape[-2:])
    base = initial_level(img, cfg)
    out = []
    for _ in range(n_oct):
        if fused and min(base.shape[-2:]) >= 64:
            samp, dog, score = k3.fused_octave(base, cfg)
        else:
            gauss = torch.stack(octave_levels(base, cfg), -3)
            dog = gauss[..., 1:, :, :] - gauss[..., :-1, :, :]
            samp = gauss[..., 1:s_ + 1, :, :]
            # bf16 scores only rank candidates; refinement reads the f32 DoG
            sdog = dog.to(torch.bfloat16) if cfg.score_dtype == "bf16" else dog
            score = extrema_score(sdog, cfg)
        out.append((samp, dog, score))
        base = downsample2(samp[..., s_ - 1, :, :])   # level S: 2x sigma0 blur
    return out


def _features(planes, cfg: SiftConfig) -> SiftFeatures:
    """Detection onwards for a [B] batch of frames from its octaves' planes
    ([B, ...] each): one program over the batch, every kernel launched
    once an octave and a use for all frames, each frame's features those of
    that frame alone."""
    parts = []
    for oi, (samp, dog, score) in enumerate(planes):
        with trace.span("sift.detect", id=oi):
            kps = detect_from_score(dog, score, oi, cfg)
        with trace.span("sift.orientation", id=oi):
            # keypoints live on DoG levels 1..S, the sampler-level stack
            hist = orientation_histograms(samp, kps, cfg, level_base=1)
            theta, ok = dominant_orientations(hist, cfg)
        with trace.span("sift.describe", id=oi):
            slots = compact_slots(kps, theta, ok, cfg.desc_slots(oi))
            desc, slot_valid = descriptors(samp, slots, cfg, level_base=1)
        parts.append(_features_from(slots, desc, slot_valid))
    with trace.span("sift.topk"):
        feats = SiftFeatures(*(torch.cat(xs, 1) for xs in zip(*parts)))
        return _topk(feats, cfg.total_kpts)


def extract(img, cfg: SiftConfig = SiftConfig(), *, device=None) -> SiftFeatures:
    """SIFT features of a [H, W] grayscale image in [0, 1].

    `img` is a tensor, which stays on its device, or a numpy array, which
    goes to `device` (default "cuda"; see `utils/device.py`).  Returns a
    SiftFeatures buffer of static capacity cfg.total_kpts.  The code is
    `extract_batch`'s at B = 1, as the reference's vmap shares `extract`'s
    body.
    """
    pin_f32()
    img = as_input(img, device)
    if img.ndim != 2:
        raise ValueError(f"extract takes one [H, W] image, got {tuple(img.shape)}")
    with trace.span("sift.extract", frames=1):
        trace.count("sift.frames")
        feats = _features(_octave_planes(img[None], cfg), cfg)
        return SiftFeatures(*(a[0] for a in feats))


def extract_batch(imgs, cfg: SiftConfig = SiftConfig(), *,
                  device=None) -> SiftFeatures:
    """Extraction over a [B, H, W] batch of frames, as one batched program
    (the reference's `jax.vmap(extract)`).

    The pyramid of every octave is built for all frames at once (one K3
    launch per octave on the fused path), and detection, orientation and
    descriptors run over the batch: each sampler kernel launches once an
    octave and a use for all B frames.  Each frame's features equal
    `extract` of that frame bit for bit.  Fields carry a leading [B] axis,
    as the reference's `vmap` gives.  `device` as for `extract`.
    """
    pin_f32()
    imgs = as_input(imgs, device)
    if imgs.ndim != 3:
        raise ValueError(f"extract_batch takes a [B, H, W] batch, got {tuple(imgs.shape)}")
    with trace.span("sift.extract", frames=imgs.shape[0]):
        trace.count("sift.frames", imgs.shape[0])
        return _features(_octave_planes(imgs, cfg), cfg)

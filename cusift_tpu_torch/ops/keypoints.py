"""Static-capacity keypoint buffers (twin of `cusift_tpu/ops/keypoints.py`).

A fixed-capacity struct-of-arrays with a validity mask; "append" is top-k
compaction by detection response.  Invalid lanes must be masked by every
consumer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Keypoints(NamedTuple):
    """[K]-shaped struct-of-arrays ([B, K] for a batch of frames); `valid`
    masks live lanes.

    (x, y, sigma) are in the base input-image frame; (xo, yo, so, octave,
    level) in the octave-local frame the samplers use.
    """

    x: torch.Tensor          # [K] float32
    y: torch.Tensor          # [K] float32
    sigma: torch.Tensor      # [K] float32, blur in base-image units
    response: torch.Tensor   # [K] float32
    edgeness: torch.Tensor   # [K] float32
    octave: torch.Tensor     # [K] int32
    level: torch.Tensor      # [K] int32 (DoG level of the extremum, 1..S)
    xo: torch.Tensor         # [K] float32, octave-local column
    yo: torch.Tensor         # [K] float32, octave-local row
    so: torch.Tensor         # [K] float32, refined level coordinate
    valid: torch.Tensor      # [K] bool

    @property
    def count(self):
        return self.valid.sum()


def empty_keypoints(k: int, device=None) -> Keypoints:
    """k invalid lanes of zeros on `device` ("cuda" unless the caller asks
    for the CPU)."""
    from ..utils.device import run_device

    dev = run_device(device, "empty_keypoints")
    f = torch.zeros((k,), dtype=torch.float32, device=dev)
    i = torch.zeros((k,), dtype=torch.int32, device=dev)
    return Keypoints(x=f, y=f, sigma=f, response=f, edgeness=f, octave=i, level=i,
                     xo=f, yo=f, so=f, valid=torch.zeros((k,), dtype=torch.bool, device=dev))


def concat_keypoints(parts: list[Keypoints]) -> Keypoints:
    """The parts' lanes one after another, field by field (along the last,
    slot, axis; leading frame axes are kept)."""
    return Keypoints(*(torch.cat(xs, -1) for xs in zip(*parts)))


def top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis of score
    [..., M], each row on its own, ties to the lower index (the order of
    `lax.top_k`; `torch.topk` promises none)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def take(kps, idx: torch.Tensor):
    """Gather every field of a NamedTuple buffer at idx [..., k]: the
    fields' axis idx.ndim - 1 is the slot axis, any axes after it ride
    along (a descriptor's 128)."""
    def at(a):
        return torch.take_along_dim(a, idx.reshape(idx.shape + (1,) * (a.ndim - idx.ndim)),
                                    idx.ndim - 1)
    return type(kps)(*(at(a) for a in kps))


def topk_keypoints(kps: Keypoints, k: int) -> Keypoints:
    """Compact to the k highest-|response| valid keypoints (static shape),
    per frame where the fields carry a leading frame axis."""
    score = torch.where(kps.valid, kps.response.abs(),
                        torch.full_like(kps.response, -torch.inf))
    idx = top_indices(score, k)
    out = take(kps, idx)
    return out._replace(valid=out.valid & torch.isfinite(score.gather(-1, idx)))

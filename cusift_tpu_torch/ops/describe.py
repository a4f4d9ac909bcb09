"""128-d SIFT descriptors as fixed-grid sampling + one contraction (twin of
`cusift_tpu/ops/describe.py`).

Each (keypoint, orientation) slot samples a fixed G x G grid in its
rotated frame, so the spatial trilinear weights are a static [G^2, 16]
matrix; only the 8-way orientation binning depends on the data.  The
sampling goes through kernel K1, or, with `sampler="fused"`, kernel K5
samples, bins and contracts in one pass.  A batch of frames ([B, ...]
planes and slots) goes through each kernel in one launch, and a frame's
descriptors do not depend on the batch around it (`_cell_sums`,
`_l2_normalised`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SiftConfig
from ..kernels import sampler as k
from .keypoints import Keypoints, top_indices
from .sampling import sample_grad_pair


class Slots(NamedTuple):
    """Compacted (keypoint, orientation) slots of one octave, [N]-shaped
    ([B, N] for a batch of frames)."""

    x: torch.Tensor
    y: torch.Tensor
    sigma: torch.Tensor
    response: torch.Tensor
    edgeness: torch.Tensor
    octave: torch.Tensor
    level: torch.Tensor
    xo: torch.Tensor
    yo: torch.Tensor
    so: torch.Tensor
    theta: torch.Tensor
    valid: torch.Tensor


def compact_slots(kps: Keypoints, theta: torch.Tensor, ok: torch.Tensor,
                  n_slots: int) -> Slots:
    """Flatten [..., K, M] orientation slots and keep the n_slots best-valid
    of each frame.

    Both slots of one keypoint tie on score; the tie goes to the lower
    flat index (the reference's `lax.top_k` order).
    """
    m = theta.shape[-1]
    valid = (ok & kps.valid[..., None]).flatten(-2)
    resp = kps.response[..., None].expand(theta.shape).flatten(-2)
    score = torch.where(valid, 1.0 + resp.abs(), torch.zeros_like(resp))
    idx = top_indices(score, n_slots)
    src = idx // m                    # keypoint of each kept flat slot

    def at(a, i=src):
        return a.gather(-1, i)

    return Slots(
        x=at(kps.x), y=at(kps.y), sigma=at(kps.sigma),
        response=at(resp, idx), edgeness=at(kps.edgeness),
        octave=at(kps.octave), level=at(kps.level),
        xo=at(kps.xo), yo=at(kps.yo), so=at(kps.so),
        theta=at(theta.flatten(-2), idx), valid=at(valid, idx) & (at(score, idx) > 0),
    )


def _cell_weights(g: int, d: int) -> np.ndarray:
    """[g, d] bilinear weight of grid row (or column) i on cell row (or
    column) p: max(0, 1 - |coordinate - cell centre|); coordinates span
    [-d/2, d/2]."""
    c = (np.arange(g, dtype=np.float32) + 0.5) / g * d - d / 2.0
    centres = np.arange(d, dtype=np.float32) - d / 2.0 + 0.5      # [d]
    return np.maximum(0.0, 1.0 - np.abs(c[:, None] - centres[None, :]))


def _spatial_weights(g: int, d: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static grid geometry: (cell_coords [g*g, 2], W_spatial [g*g, d*d],
    gauss [g*g]); cell coordinates span [-d/2, d/2].  W_spatial is
    separable: its entry (i*g + j, p*d + q) is a[i, p] * a[j, q] of
    a = `_cell_weights`."""
    c = (np.arange(g, dtype=np.float32) + 0.5) / g * d - d / 2.0
    vv, uu = np.meshgrid(c, c, indexing="ij")                     # v=row, u=col
    coords = np.stack([vv.ravel(), uu.ravel()], -1)               # [g*g, 2]
    a = _cell_weights(g, d)
    w_spatial = (a[:, None, :, None] * a[None, :, None, :]).reshape(g * g, d * d)
    gauss = np.exp(-(coords ** 2).sum(-1) / (0.5 * d * d))        # sigma = d/2
    return (coords.astype(np.float32), w_spatial.astype(np.float32),
            gauss.astype(np.float32))


def _cell_sums(contrib: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """[..., N, d*d*nb] descriptor of contrib [..., N, g*g, nb], cells major:
    sum_s W_spatial[s, c] * contrib[s], as the separable W_spatial allows,
    over grid columns and then grid rows (a [g, d], `_cell_weights`).

    Each sum is a product and a sum over a short axis, which adds every
    output's terms in one order whatever the number of slots; the einsum
    it replaces is a GEMM whose blocking (and so its bits) may move with
    the row count, that is with the batch around a frame."""
    g, d = a.shape
    c = contrib.unflatten(-2, (g, g))                              # [..., N, i, j, nb]
    t = (c.unsqueeze(-2) * a[:, :, None]).sum(-3)                  # [..., N, i, q, nb]
    out = (t.unsqueeze(-3) * a[:, :, None, None]).sum(-4)         # [..., N, p, q, nb]
    return out.flatten(-3)


def _l2_normalised(desc: torch.Tensor, nb: int) -> torch.Tensor:
    """desc [..., cells * nb] over its L2 norm (floored at 1e-12), the
    squares summed a cell's nb at a time and then the cells' sums:
    reductions this short run in one order whatever the number of rows,
    where the GPU's split of a 128-long row across threads moves with it."""
    sq = (desc * desc).unflatten(-1, (-1, nb)).sum(-1).sum(-1, keepdim=True)
    return desc / torch.sqrt(sq).clamp(min=1e-12)


def descriptors(gauss: torch.Tensor, slots: Slots,
                cfg: SiftConfig, level_base: int = 0):
    """Descriptors for compacted slots of one octave.

    gauss: [..., L, H, W] blurred levels, slots fields [..., N] with the
    same leading (frame) axes; plane i is Gaussian level i + level_base.
    Returns (desc [..., N, 128], slot_valid [..., N]).
    """
    g, d, nb = cfg.desc_grid, cfg.desc_width, cfg.desc_bins
    dev = gauss.device
    coords, w_spatial, gw = (torch.as_tensor(a, device=dev)
                             for a in _spatial_weights(g, d))

    th = slots.theta
    slot_valid = slots.valid
    lvl = (slots.level - level_base).clamp(0, gauss.shape[-3] - 1)

    sigma_oct = cfg.sigma0 * torch.pow(2.0, slots.so / cfg.scales_per_octave)
    cell_w = cfg.desc_scale_factor * sigma_oct                 # px per cell
    ct, st = torch.cos(th)[..., None], torch.sin(th)[..., None]
    # rotate descriptor-frame coords (v=row, u=col) into the image frame
    u = coords[:, 1] * cell_w[..., None]                       # [..., N, S]
    v = coords[:, 0] * cell_w[..., None]
    xs = slots.xo[..., None] + u * ct - v * st
    ys = slots.yo[..., None] + u * st + v * ct

    if cfg.sampler == "fused":
        wv = gw.expand(xs.shape).contiguous()
        raw = k.sample_desc_raw(gauss.contiguous(), lvl.to(torch.int32).contiguous(),
                                ys.contiguous(), xs.contiguous(), th.contiguous(),
                                wv, w_spatial, nb)                  # [..., N, nb, 16]
        desc = raw.transpose(-1, -2).flatten(-2)
    else:
        dx, dy, inb = sample_grad_pair(gauss, lvl, ys, xs, method=cfg.sampler)
        contrib = k.descriptor_contrib(dx, dy, inb, th, gw, nb)
        desc = _cell_sums(contrib, torch.as_tensor(_cell_weights(g, d), device=dev))

    # normalise -> clip -> renormalise (Lowe)
    desc = _l2_normalised(desc, nb).clamp(max=cfg.desc_clip)
    desc = _l2_normalised(desc, nb)
    return desc * slot_valid[..., None], slot_valid

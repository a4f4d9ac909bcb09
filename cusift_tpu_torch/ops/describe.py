"""128-d SIFT descriptors as fixed-grid sampling + one contraction (twin of
`cusift_tpu/ops/describe.py`).

Each (keypoint, orientation) slot samples a fixed G x G grid in its
rotated frame, so the spatial trilinear weights are a static [G^2, 16]
matrix; only the 8-way orientation binning depends on the data.  The
sampling goes through kernel K1, or, with `sampler="fused"`, kernel K5
samples, bins and contracts in one pass.
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
    """Compacted (keypoint, orientation) slots of one octave, [N]-shaped."""

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
    """Flatten [K, M] orientation slots and keep the n_slots best-valid.

    Both slots of one keypoint tie on score; the tie goes to the lower
    flat index (the reference's `lax.top_k` order).
    """
    m = theta.shape[1]
    valid = (ok & kps.valid[:, None]).reshape(-1)
    resp = kps.response.repeat_interleave(m)
    score = torch.where(valid, 1.0 + resp.abs(), torch.zeros_like(resp))
    idx = top_indices(score, n_slots)
    src = idx // m                    # keypoint of each kept flat slot
    return Slots(
        x=kps.x[src], y=kps.y[src], sigma=kps.sigma[src],
        response=resp[idx], edgeness=kps.edgeness[src],
        octave=kps.octave[src], level=kps.level[src],
        xo=kps.xo[src], yo=kps.yo[src], so=kps.so[src],
        theta=theta.reshape(-1)[idx], valid=valid[idx] & (score[idx] > 0),
    )


def _spatial_weights(g: int, d: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static grid geometry: (cell_coords [g*g, 2], W_spatial [g*g, d*d],
    gauss [g*g]); cell coordinates span [-d/2, d/2]."""
    c = (np.arange(g, dtype=np.float32) + 0.5) / g * d - d / 2.0
    vv, uu = np.meshgrid(c, c, indexing="ij")                     # v=row, u=col
    coords = np.stack([vv.ravel(), uu.ravel()], -1)               # [g*g, 2]
    centres = np.arange(d, dtype=np.float32) - d / 2.0 + 0.5      # [d]
    wv = np.maximum(0.0, 1.0 - np.abs(coords[:, 0:1] - centres[None, :]))
    wu = np.maximum(0.0, 1.0 - np.abs(coords[:, 1:2] - centres[None, :]))
    w_spatial = (wv[:, :, None] * wu[:, None, :]).reshape(g * g, d * d)
    gauss = np.exp(-(coords ** 2).sum(-1) / (0.5 * d * d))        # sigma = d/2
    return (coords.astype(np.float32), w_spatial.astype(np.float32),
            gauss.astype(np.float32))


def descriptors(gauss: torch.Tensor, slots: Slots,
                cfg: SiftConfig, level_base: int = 0):
    """Descriptors for compacted slots of one octave.

    gauss: [L, H, W] blurred levels; plane i is Gaussian level
    i + level_base.  Returns (desc [N, 128], slot_valid [N]).
    """
    g, d, nb = cfg.desc_grid, cfg.desc_width, cfg.desc_bins
    dev = gauss.device
    coords, w_spatial, gw = (torch.as_tensor(a, device=dev)
                             for a in _spatial_weights(g, d))

    th = slots.theta
    slot_valid = slots.valid
    lvl = (slots.level - level_base).clamp(0, gauss.shape[0] - 1)
    n = th.shape[0]

    sigma_oct = cfg.sigma0 * torch.pow(2.0, slots.so / cfg.scales_per_octave)
    cell_w = cfg.desc_scale_factor * sigma_oct                 # px per cell
    ct, st = torch.cos(th), torch.sin(th)
    # rotate descriptor-frame coords (v=row, u=col) into the image frame
    u = coords[None, :, 1] * cell_w[:, None]                   # [N, S]
    v = coords[None, :, 0] * cell_w[:, None]
    xs = slots.xo[:, None] + u * ct[:, None] - v * st[:, None]
    ys = slots.yo[:, None] + u * st[:, None] + v * ct[:, None]

    if cfg.sampler == "fused":
        wv = gw[None, :].expand(n, -1).contiguous()
        raw = k.sample_desc_raw(gauss.contiguous(), lvl.to(torch.int32).contiguous(),
                                ys.contiguous(), xs.contiguous(), th.contiguous(),
                                wv, w_spatial, nb)                  # [N, nb, 16]
        desc = raw.transpose(1, 2).reshape(n, d * d * nb)
    else:
        dx, dy, inb = sample_grad_pair(gauss, lvl, ys, xs, method=cfg.sampler)
        contrib = k.descriptor_contrib(dx, dy, inb, th, gw[None, :], nb)
        desc = torch.einsum("sc,ksb->kcb", w_spatial, contrib)  # [N, 16, 8]
        desc = desc.reshape(n, d * d * nb)

    # normalise -> clip -> renormalise (Lowe)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / norm.clamp(min=1e-12)
    desc = desc.clamp(max=cfg.desc_clip)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / norm.clamp(min=1e-12)
    return desc * slot_valid[:, None], slot_valid

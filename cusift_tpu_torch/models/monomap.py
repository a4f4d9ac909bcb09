"""Persistent-landmark map tracking for monocular VO, scale anchoring
(twin of `cusift_tpu/models/monomap.py`).

The per-pair depth-ratio scale chain's error is coherent within a pair and
random-walks through the chain.  The map-anchored frontend keeps a
persistent table of 3-D landmarks in the raw odometry frame and localises
every frame against it with PnP RANSAC (`ops/pnp.py`): a landmark's scale
error is set at its creation epoch and averaged over landmarks of many
epochs at every localisation.  Loop closures correct trajectories through
the Sim(3) layer at output time and never rewrite the map; matching sees
only recently seen landmarks (`VOConfig.map_active_kf`).  The reference
marks the mode experimental and frozen (`VOConfig.map_anchor`); it is
ported as it is.

Shapes are static: a fixed-capacity landmark table, one localisation step
a frame (match with kernel K2, PnP, the pose selection, depth re-scaling,
the seen-epoch scatter and the landmark refinement) and one insertion step
a keyframe (top-k eviction of invalid then oldest slots, top-k
response-ranked candidates).  The pose state stays on the device and is
updated inside the step; the host reads it from the step's [17] row.

The refinement's two scatter-adds go through `kernels/segment.py`, so
reruns on the card are bit-identical.  Both top-k's break ties to the
lower index, as `lax.top_k` does (`ops/keypoints.py:top_indices`): the
eviction key is tied across every landmark of an epoch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchConfig, RansacConfig
from ..kernels import segment
from ..ops.geometry import masked_median
from ..ops.keypoints import top_indices
from ..ops.match import match
from ..ops.pnp import find_pnp
from ..utils.device import run_device
from ..utils.precision import f32_matmuls


class LandmarkMap(NamedTuple):
    """Fixed-capacity landmark table (device tensors)."""

    pos: torch.Tensor    # [M, 3] world-frame positions (raw-chain frame)
    desc: torch.Tensor   # [M, 128] descriptor at creation
    valid: torch.Tensor  # [M] bool
    seen: torch.Tensor   # [M] int32 keyframe epoch last observed (-1 = never)
    nobs: torch.Tensor   # [M] int32 observations folded into `pos`


class MapTrack(NamedTuple):
    """Device-side outputs of one map-tracking frame step."""

    packed: torch.Tensor   # [17] host fetch: r(9), t(3), scale, n_pnp,
                           #      ok_pnp, s_med, n_anchor
    pose_r: torch.Tensor   # [3, 3] selected world-to-camera pose
    pose_t: torch.Tensor   # [3]
    rel_r: torch.Tensor    # [3, 3] selected relative motion (next fallback)
    rel_t: torch.Tensor    # [3]
    scale: torch.Tensor    # scalar: running per-pair |t| scale state
    depth: torch.Tensor    # [N] per-slot depth, map-anchored units
    pts: torch.Tensor      # [N, 3] camera-frame points, map-anchored units
    inliers: torch.Tensor  # [N] bool: slots that localised against the map
    lmap: LandmarkMap      # updated map (refined positions, seen, nobs)


def empty_map(size: int, device=None) -> LandmarkMap:
    """An empty table of `size` slots on `device` ("cuda" unless the caller
    asks for the CPU)."""
    dev = run_device(device, "empty_map")
    return LandmarkMap(pos=torch.zeros((size, 3), device=dev),
                       desc=torch.zeros((size, 128), device=dev),
                       valid=torch.zeros(size, dtype=torch.bool, device=dev),
                       seen=torch.full((size,), -1, dtype=torch.int32, device=dev),
                       nobs=torch.zeros(size, dtype=torch.int32, device=dev))


def _xyn(x, y, intr):
    return torch.stack([(x - intr[2]) / intr[0], (y - intr[3]) / intr[1]], -1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


@f32_matmuls
def localize_step(desc, valid, x, y, intr, depth_chain, pts_chain,
                  pair_ok, pair_r_rel, pair_t_rel, chain_scale, prev_scale,
                  prev_r, prev_t, last_rel_r, last_rel_t,
                  lmap: LandmarkMap, kf_epoch: int, active_lo: int, min_inliers: int,
                  min_obs: int, min_anchor: int, scale_gain: float,
                  match_cfg: MatchConfig, ransac_cfg: RansacConfig,
                  generator: torch.Generator) -> MapTrack:
    """Finish one map-anchored frame: match + PnP + on-device pose select.

    Consumes the frame's `pair_step` outputs (chain-scaled depths and
    points, relative motion, chain scale) and the device pose state, and
    selects between the map's scale (preferred), a pure-PnP rescue of a
    failed pair and the chain / constant-velocity fallback on the device.
    On accept the frame's depths and points are re-scaled from chain units
    into map units; depths of a rejected pair stay zero.
    """
    xyn = _xyn(x, y, intr)
    active = lmap.valid & (lmap.seen >= active_lo)
    m = match(desc, valid, lmap.desc, active, match_cfg)
    idx = m.idx.long()
    pts_lm = lmap.pos[idx]
    ok_m = m.ok & valid

    # the chain candidate (constant velocity on a failed pair) seeds the
    # PnP hypothesis pool as the motion prior
    r_rel_c = torch.where(pair_ok, pair_r_rel, last_rel_r)
    t_rel_c = torch.where(pair_ok, pair_t_rel, last_rel_t)
    r_chain = r_rel_c @ prev_r
    t_chain = r_rel_c @ prev_t + t_rel_c
    res = find_pnp(pts_lm, xyn, ok_m, ransac_cfg, generator, init=(r_chain, t_chain))

    # the pose-free scale observable: the ratio of inter-point distances of
    # the matched landmark cloud (map units) and this frame's |t| = 1
    # triangulation, median over rolled pairings at three strides, on
    # MATURE landmarks (>= min_obs folded observations) within the pair
    # step's parallax cut and with a minimum fresh separation
    za_unit = depth_chain / chain_scale.clamp(min=1e-12)
    p_unit = pts_chain / chain_scale.clamp(min=1e-12)
    mature = lmap.nobs[idx] >= min_obs
    good = res.inliers & ok_m & mature & (za_unit > 1e-6) & (za_unit < 500.0)
    ratios, masks = [], []
    for shift in (1, 3, 7):
        d_map = _norm(pts_lm - torch.roll(pts_lm, shift, 0))
        d_unit = _norm(p_unit - torch.roll(p_unit, shift, 0))
        ratios.append(d_map / d_unit.clamp(min=1e-9))
        masks.append(good & torch.roll(good, shift, 0) & (d_unit > 1.0))
    n_anchor = good.sum()
    s_med = masked_median(torch.cat(ratios), torch.cat(masks))
    pnp_geom = res.ok & (res.num_inliers >= min_inliers)
    ok = (pnp_geom & pair_ok & (n_anchor >= min_anchor)
          & torch.isfinite(s_med) & (s_med > 1e-9)
          & (s_med < 2.0 * prev_scale) & (s_med > prev_scale / 2.0))
    # damped anchor: move the chain scale toward the map's at `scale_gain`
    s_anch = chain_scale * (s_med / chain_scale.clamp(min=1e-12)) ** scale_gain
    t_dir = pair_t_rel / _norm(pair_t_rel).clamp(min=1e-12)
    rel_t_a = t_dir * s_anch

    # pure-PnP rescue: the pair failed but the map still localises
    r_rel_p = res.r @ prev_r.T
    t_rel_p = res.t - r_rel_p @ prev_t
    s_pnp = _norm(t_rel_p)
    rescue = pnp_geom & ~pair_ok & torch.isfinite(s_pnp) & (s_pnp < 2.0 * prev_scale)

    rel_r = torch.where(rescue, r_rel_p, r_rel_c)
    rel_t = torch.where(ok, rel_t_a, torch.where(rescue, t_rel_p, t_rel_c))
    r_new = rel_r @ prev_r
    t_new = rel_r @ prev_t + rel_t
    # running scale: anchored > rescued > chain > held
    s_new = torch.where(ok, s_anch, torch.where(rescue, s_pnp,
                                                torch.where(pair_ok, chain_scale, prev_scale)))
    ratio = torch.where(ok, s_anch / chain_scale.clamp(min=1e-12), torch.ones_like(s_anch))
    zero = torch.zeros((), dtype=depth_chain.dtype, device=depth_chain.device)
    depth = torch.where(pair_ok, depth_chain * ratio, zero)      # the garbage-depth rule
    pts_b = torch.where(pair_ok, pts_chain * ratio, zero)
    ok = ok | rescue

    # bookkeeping keys on the geometric inlier set, not the scale accept
    # (landmarks mature through refinement, and the accept needs mature ones)
    inl = res.inliers & ok_m & pnp_geom
    seen_rows = torch.where(inl, torch.full_like(idx, kf_epoch), -1).to(lmap.seen.dtype)
    seen = lmap.seen.scatter_reduce(0, idx, seen_rows, "amax")
    # refinement: fold this frame's triangulation of each inlier landmark
    # into a running mean of world positions, ONE observation a frame
    # (several rows may best-match one landmark: segment-mean them first),
    # and freeze a landmark once it holds min_obs observations
    upd = inl & (depth > 1e-6) & (lmap.nobs[idx] < min_obs)
    pts_cam = torch.cat([xyn, torch.ones_like(xyn[:, :1])], -1) * depth[:, None]
    fresh_w = (pts_cam - t_new) @ r_new                           # rows: R^T (x - t)
    plan = segment.plan(idx, lmap.pos.shape[0])
    cnt = segment.segment_sum(upd.to(torch.float32), plan)
    sum_f = segment.segment_sum(torch.where(upd[:, None], fresh_w, zero), plan)
    has = cnt > 0.0
    mean_f = sum_f / cnt.clamp(min=1.0)[:, None]
    w_obs = 1.0 / (lmap.nobs.to(torch.float32) + 1.0)
    pos = torch.where(has[:, None], lmap.pos + (mean_f - lmap.pos) * w_obs[:, None], lmap.pos)
    nobs = lmap.nobs + has.to(lmap.nobs.dtype)
    lmap2 = LandmarkMap(pos=pos, desc=lmap.desc, valid=lmap.valid, seen=seen, nobs=nobs)
    packed = torch.cat([r_new.reshape(-1), t_new,
                        torch.stack([s_new, res.num_inliers.to(torch.float32),
                                     ok.to(torch.float32), s_med,
                                     n_anchor.to(torch.float32)])])
    return MapTrack(packed=packed, pose_r=r_new, pose_t=t_new, rel_r=rel_r, rel_t=rel_t,
                    scale=s_new, depth=depth, pts=pts_b, inliers=inl, lmap=lmap2)


@f32_matmuls
def insert_step(lmap: LandmarkMap, desc, valid, response, x, y, intr, depth,
                already_inlier, pose_r, pose_t, kf_epoch: int, budget: int) -> LandmarkMap:
    """Insert up to `budget` new landmarks from the current keyframe.

    Candidates: valid slots with a (map-scale) depth that did not just
    localise against an existing landmark, ranked by DoG response.  Slots:
    invalid first, then the oldest seen (the map is a recency ring).
    """
    budget = min(budget, valid.shape[0], lmap.valid.shape[0])
    xyn = _xyn(x, y, intr)
    good = valid & (depth > 1e-6) & ~already_inlier
    pts_cam = torch.cat([xyn, torch.ones_like(xyn[:, :1])], -1) * depth[:, None]
    pts_w = (pts_cam - pose_t) @ pose_r                           # rows: R^T (x - t)

    cand_idx = top_indices(torch.where(good, response, -torch.inf), budget)
    cand_good = good[cand_idx]
    evict_key = torch.where(lmap.valid, -lmap.seen.to(torch.float32), torch.inf)
    slot_idx = top_indices(evict_key, budget)

    def put(table, rows):
        keep = cand_good.reshape((-1,) + (1,) * (rows.dim() - 1))
        return table.index_copy(0, slot_idx, torch.where(keep, rows, table[slot_idx]))

    n = cand_good.shape[0]
    return LandmarkMap(
        pos=put(lmap.pos, pts_w[cand_idx]), desc=put(lmap.desc, desc[cand_idx]),
        valid=put(lmap.valid, torch.ones(n, dtype=torch.bool, device=good.device)),
        seen=put(lmap.seen, torch.full((n,), kf_epoch, dtype=lmap.seen.dtype,
                                       device=good.device)),
        nobs=put(lmap.nobs, torch.ones(n, dtype=lmap.nobs.dtype, device=good.device)))

"""Monocular visual odometry, the KITTI frontend of BASELINE configs[4]
(twin of `cusift_tpu/models/odometry.py`).

A pair step runs on the device: extraction of the new frame (kernel K1 in
every octave), matching against the previous frame or keyframe (kernel
K2), essential RANSAC, midpoint triangulation and the depth-ratio scale
chain, packed into ONE [18] float row that the host copies once.  Global
scale is unobservable from one camera; the trajectory is metrically
consistent up to that one factor.

The PnP rescue of a failed essential fit is a second device step: the
reference branches on the device (`lax.cond`), so healthy frames pay
nothing; here the host reads the packed row, and only when it says the
essential fit failed with enough chained depths does it run `find_pnp` and
fetch a second row.  The rescued results equal the reference's always-on
selection (`_pnp_rescue` applied to every frame).

With a `VOConfig` the frontend is sequence-scale: a fixed-capacity
keyframe ring on the device (descriptors, normalised coordinates, chained
depths), loop-closure retrieval and essential verification of the top 3
candidates per keyframe (`_loop_verify_step`, one [20] fetch), and a
Sim(3) pose graph over the keyframes (`optim/sim3graph.py`) whose
correction `trajectory()` composes on output, behind the two-route
speed/smoothness gate.  Poses, edges and the correction live on the host.

Randomness: each step's RANSAC calls get `torch.Generator`s seeded from
(seed, counter), one counter step per pair (two generators: essential,
PnP) and per loop verification (three), as the reference splits one
threefry key per step.  `dist_ba=True` shards the window BA over the
"map" axis of every rank of the default process group (creating a
one-rank group when there is none; see `models/slam.py`).
`VOConfig.map_anchor=True` raises `NotImplementedError`: the map-anchored
frontend (`models/monomap.py`) is not ported yet (ROADMAP queue 1,
item 11).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import (BAConfig, MatchConfig, PoseGraphConfig, RansacConfig,
                      SiftConfig, VOConfig, replace)
from ..convert import mono_checkpoint_arrays, mono_state_fields
from ..ops.essential import find_essential, triangulate_midpoint
from ..ops.geometry import masked_median as _masked_median
from ..ops.match import match
from ..ops.pnp import find_pnp
from ..ops.ransac import find_homography, step_generators
from ..optim.sim3graph import Sim3Graph, optimize as sim3_optimize
from ..utils.device import run_device
from ..utils.image import pad_to_tier as _pad_to_tier
from ..utils.pipeline import _uploaded
from ..utils.precision import f32_matmuls
from .evict import select_victim
from .local_ba import window_ba
from .sift import SiftFeatures, extract
from .slam import _f32, _kf_scores
from .twoview import mask_to_content

__all__ = ["MonoVO", "PairOdometry", "pair_step", "_masked_median"]


class PairOdometry(NamedTuple):
    """Device-side result of one odometry pair step."""

    feats: SiftFeatures         # frame B features (carried to the next pair)
    r_rel: torch.Tensor         # [3, 3] with x_b = R x_a + t
    t_rel: torch.Tensor         # [3] globally-scaled translation
    scale: torch.Tensor         # scalar applied to the unit translation
    depth: torch.Tensor         # [N] triangulated depth per frame-B slot
    pts: torch.Tensor           # [N, 3] frame-B camera-frame points (z = 0 unknown)
    num_inliers: torch.Tensor   # int
    scale_common: torch.Tensor  # int: tracked points used for the scale
    ok: torch.Tensor            # bool: a pose was measured this pair
    pnp_used: torch.Tensor      # bool: the PnP rescue supplied the pose


class _Rescue(NamedTuple):
    """What the PnP rescue reads from a pair step."""

    pts_a3: torch.Tensor        # [N, 3] frame-A points at the chain's scale
    xb: torch.Tensor            # [N, 2] matched frame-B normalised coords
    have3d: torch.Tensor        # [N] matched with a chained depth
    depth_vals: torch.Tensor    # [N] the essential branch's frame-B depths
    idx: torch.Tensor           # [N] match index into frame B
    xb_all: torch.Tensor        # [M, 2] every frame-B slot, normalised
    try_pnp: torch.Tensor       # bool: essential failed, enough depths


# the packed row: [r_rel 9 | t_rel 3 | scale, inliers, scale_common, ok,
# pnp_used, try_pnp]
ROW = 18


def _normalised(x, y, intr):
    return torch.stack([(x - intr[2]) / intr[0], (y - intr[3]) / intr[1]], -1)


def _result(fb: SiftFeatures, rescue: _Rescue, r, t, scale, depth_vals, n_inl,
            n_common, ok, pnp_used) -> PairOdometry:
    """Frame B's per-slot depths through the match index (the last row
    matched to a slot writes it, as the reference's scatter does) and its
    camera-frame points."""
    n_b = rescue.xb_all.shape[0]
    rows = torch.arange(rescue.idx.shape[0], device=rescue.idx.device)
    last = torch.full((n_b,), -1, dtype=torch.long, device=rows.device).scatter_reduce(
        0, rescue.idx, rows, "amax")
    depth_b = torch.where(last >= 0, depth_vals[last.clamp(min=0)],
                          torch.zeros((), dtype=depth_vals.dtype, device=rows.device))
    xb_h = torch.cat([rescue.xb_all, torch.ones_like(rescue.xb_all[:, :1])], -1)
    return PairOdometry(feats=fb, r_rel=r, t_rel=t, scale=scale, depth=depth_b,
                        pts=xb_h * depth_b[:, None], num_inliers=n_inl,
                        scale_common=n_common, ok=ok, pnp_used=pnp_used)


@f32_matmuls
def _pair_core(desc_a, valid_a, xy_a, depth_a, img_b, intr, prev_scale,
               sift_cfg: SiftConfig, match_cfg: MatchConfig,
               ransac_cfg: RansacConfig, generator, content=None):
    """The pair step up to the PnP rescue: (PairOdometry, _Rescue)."""
    fb = extract(img_b, sift_cfg)
    if content is not None:
        fb = mask_to_content(fb, content, sift_cfg.border)
    m = match(desc_a, valid_a, fb.desc, fb.valid, match_cfg)
    idx = m.idx.long()
    xa = _normalised(xy_a[:, 0], xy_a[:, 1], intr)
    xb_all = _normalised(fb.x, fb.y, intr)
    xb = xb_all[idx]
    res = find_essential(xa, xb, m.ok, ransac_cfg, generator)
    _, za, zb = triangulate_midpoint(res.r, res.t, xa, xb)
    good = res.inliers & (za > 1e-6) & (zb > 1e-6)
    # scale chaining: features seen in the previous pair carry a global
    # depth in frame A; the ratio's median to the fresh |t| = 1
    # triangulation is this pair's scale.  za beyond ~500 baselines (under
    # ~0.1 deg of parallax) is noise with a heavy high tail: gated out
    low_parallax = (za > 500.0) | (zb > 500.0)
    have_prev = good & (depth_a > 1e-6) & ~low_parallax
    ratio = depth_a / za.clamp(min=1e-6)
    n_common = have_prev.sum()
    med = _masked_median(ratio, have_prev)
    scale_ok = (n_common >= 8) & torch.isfinite(med) & (med > 1e-6)
    # smooth-motion clamp: the per-pair scale steps at most 3x
    med = torch.minimum(torch.maximum(med, prev_scale / 3.0), prev_scale * 3.0)
    scale = torch.where(scale_ok, med, prev_scale)
    depth_vals = torch.where(good, zb * scale, torch.zeros_like(zb))
    pts_a3 = torch.cat([xa, torch.ones_like(xa[:, :1])], -1) * depth_a[:, None]
    have3d = m.ok & (depth_a > 1e-6)
    try_pnp = ~res.ok & (have3d.sum() >= ransac_cfg.min_matches)
    rescue = _Rescue(pts_a3=pts_a3, xb=xb, have3d=have3d, depth_vals=depth_vals,
                     idx=idx, xb_all=xb_all, try_pnp=try_pnp)
    out = _result(fb, rescue, res.r, res.t * scale, scale, depth_vals, res.num_inliers,
                  n_common, res.ok, torch.zeros_like(res.ok))
    return out, rescue


@f32_matmuls
def _pnp_rescue(out: PairOdometry, rescue: _Rescue, prev_scale,
                ransac_cfg: RansacConfig, generator) -> PairOdometry:
    """Re-measure the pose with PnP RANSAC against frame A's chain-scaled
    points and select it where the essential fit failed (`try_pnp`).  The
    pose comes out at the chain's scale, so no scale step is taken, and
    the depth chain transfers through it (z of R X_a + t).  Where try_pnp
    is false every field equals `out`'s."""
    p = find_pnp(rescue.pts_a3, rescue.xb, rescue.have3d, ransac_cfg, generator)
    use = rescue.try_pnp & p.ok
    # elementwise row-3 product, as the reference's (no matmul)
    zb_pnp = (rescue.pts_a3 * p.r[2]).sum(-1) + p.t[2]
    good_pnp = rescue.have3d & p.inliers & (zb_pnp > 1e-6)
    depth_vals = torch.where(use, torch.where(good_pnp, zb_pnp, torch.zeros_like(zb_pnp)),
                             rescue.depth_vals)
    return _result(out.feats, rescue, torch.where(use, p.r, out.r_rel),
                   torch.where(use, p.t, out.t_rel), torch.where(use, prev_scale, out.scale),
                   depth_vals, torch.where(use, p.num_inliers, out.num_inliers),
                   out.scale_common, out.ok | use, use)


def _row(out: PairOdometry, try_pnp) -> torch.Tensor:
    return torch.cat([out.r_rel.reshape(-1), out.t_rel,
                      _f32(out.scale, out.num_inliers, out.scale_common, out.ok,
                           out.pnp_used, try_pnp)])


def pair_step(desc_a, valid_a, xy_a, depth_a, img_b, intr, prev_scale,
              sift_cfg: SiftConfig = SiftConfig(),
              match_cfg: MatchConfig = MatchConfig(),
              ransac_cfg: RansacConfig = RansacConfig(),
              generators=None, content=None,
              pnp_rescue: bool = True) -> tuple[PairOdometry, np.ndarray]:
    """One monocular odometry step: previous features + new image.

    depth_a: [N] globally-scaled triangulated depth per frame-A slot (0 =
    unknown; all zeros on the first pair, which then anchors the global
    scale at |t| = 1).  `generators`: (essential, PnP) generators, seeded
    from `ransac_cfg.seed` when None.  `content`: the (h, w) of the true
    image content when img_b is tier-padded.

    Returns (PairOdometry, row): `row` is the packed [18] float row copied
    to the host (`ROW`), the step's one fetch; a failed essential fit with
    enough chained depths runs the PnP rescue as a second step and fetches
    the row again.
    """
    if generators is None:
        generators = step_generators(img_b.device, ransac_cfg.seed, 0, 2)
    out, rescue = _pair_core(desc_a, valid_a, xy_a, depth_a, img_b, intr, prev_scale,
                             sift_cfg, match_cfg, ransac_cfg, generators[0], content)
    row = _row(out, rescue.try_pnp).cpu().numpy()                # the one fetch
    if pnp_rescue and row[ROW - 1] > 0.5:
        out = _pnp_rescue(out, rescue, prev_scale, ransac_cfg, generators[1])
        row = _row(out, rescue.try_pnp).cpu().numpy()
    return out, row


@f32_matmuls
def _loop_verify_step(desc, valid, xyn, depth, kf_desc, kf_valid, kf_xyn, kf_depth,
                      exclude_lo: int, min_score: float, min_inliers: int,
                      min_common: int, match_cfg: MatchConfig,
                      ransac_cfg: RansacConfig, generators):
    """Loop-closure retrieval over keyframe slots < exclude_lo, essential
    verification of the top-3 candidates, and the two depth-ratio scales
    of a Sim(3) loop edge, packed as one [20] row
    [cand, score, ok, inliers, n_b, med_b, n_a, med_a | R 9 | t 3] of the
    candidate with the most inliers among those passing the host's gates.

    med_b: the candidate's chained depths against the fresh |t| = 1
    triangulation (the edge translation's scale in the candidate's epoch);
    med_a: the same for the current frame.  med_b / med_a is the relative
    epoch scale the Sim(3) graph consumes.  Candidates that score -inf
    (fewer than 3 slots below exclude_lo) are not verified: the
    reference verifies and then discards them.
    """
    kfcap = kf_desc.shape[0]
    active = torch.arange(kfcap, device=desc.device) < exclude_lo
    scores = _kf_scores(desc, valid, kf_desc, kf_valid, active, exclude_lo)
    _, top_idx = torch.topk(scores, min(3, kfcap))
    h_cfg = replace(ransac_cfg, inlier_thresh=2.0 * ransac_cfg.inlier_thresh_epi)
    packs, merits = [], []
    for c in range(min(3, exclude_lo, kfcap)):
        cand, gen = top_idx[c], generators[c]
        m = match(desc, valid, kf_desc[cand], kf_valid[cand], match_cfg)
        idx = m.idx.long()
        xb = kf_xyn[cand][idx]
        ok_m = m.ok & valid
        res = find_essential(xyn, xb, ok_m, ransac_cfg, gen)
        # planar-degeneracy guard (the H/E model selection): reject when a
        # homography explains almost as many correspondences as E
        hres = find_homography(xyn, xb, ok_m, h_cfg, gen)
        planar = (hres.num_inliers.to(torch.float32)
                  > 0.85 * res.num_inliers.to(torch.float32).clamp(min=1.0))
        _, za, zb = triangulate_midpoint(res.r, res.t, xyn, xb)
        good = res.inliers & (za > 1e-6) & (zb > 1e-6)
        dcand = kf_depth[cand][idx]
        have_b = good & (dcand > 1e-6)
        med_b = _masked_median(dcand / zb.clamp(min=1e-6), have_b)
        have_a = good & (depth > 1e-6)
        med_a = _masked_median(depth / za.clamp(min=1e-6), have_a)
        n_b, n_a = have_b.sum(), have_a.sum()
        ok = res.ok.to(torch.float32) * (1.0 - planar.to(torch.float32))
        packs.append(torch.cat([_f32(cand, scores[cand], ok, res.num_inliers, n_b, med_b,
                                     n_a, med_a), res.r.reshape(-1), res.t]))
        # the same gates the host applies to the winner
        accept = ((ok > 0.5) & (scores[cand] >= min_score) & (res.num_inliers >= min_inliers)
                  & (torch.minimum(n_b, n_a) >= min_common)
                  & torch.isfinite(med_b) & (med_b > 1e-6)
                  & torch.isfinite(med_a) & (med_a > 1e-6))
        merits.append(accept.to(torch.float32) * res.num_inliers.to(torch.float32))
    return torch.stack(packs)[torch.argmax(torch.stack(merits))]


class MonoVO:
    """Host-side monocular odometry loop over an image iterable.

    Composes world-to-camera poses T_k = T_rel,k o T_{k-1}; when a pair
    fails the previous relative motion is repeated (constant velocity).
    With a `vo_cfg`, keyframes, loop closures and the Sim(3) pose graph
    (see the module docstring).  Every tensor lives on `device` ("cuda"
    unless the caller asks for "cpu"); numpy frames are copied there.
    `on_metric`, if set, is called with each frame's stats.
    """

    def __init__(self, intr: np.ndarray,
                 sift_cfg: SiftConfig = SiftConfig(),
                 match_cfg: MatchConfig = MatchConfig(),
                 ransac_cfg: RansacConfig = RansacConfig(),
                 ba_window: int = 0, ba_every: int = 2,
                 ba_anchor: str = "newest",
                 pad_to_tier: bool = False,
                 vo_cfg: VOConfig | None = None,
                 pg_cfg: PoseGraphConfig = PoseGraphConfig(),
                 dist_ba: bool = False, *, device=None):
        if vo_cfg is not None and vo_cfg.map_anchor:
            raise NotImplementedError("VOConfig(map_anchor=True): models/monomap.py is "
                                      "not ported yet (ROADMAP queue 1, item 11)")
        self.device = run_device(device, "MonoVO")
        # the distributed window BA over every rank's "map" axis; the group
        # comes first, since under torchrun it picks this rank's GPU
        self._ba_mesh = None
        if dist_ba:
            from ..parallel.mesh import ensure_group, map_mesh
            self.device = ensure_group(self.device)
            self._ba_mesh = map_mesh()
        self._intr_np = np.asarray(intr, np.float32)
        self.intr = torch.from_numpy(self._intr_np.copy()).to(self.device)
        self.pad_to_tier = pad_to_tier
        self._content = None
        self.sift_cfg = sift_cfg
        self.match_cfg = match_cfg
        self.ransac_cfg = ransac_cfg
        self.ba_window = ba_window       # frames; 0 disables windowed BA
        self.ba_every = max(1, ba_every)
        self.ba_anchor = ba_anchor       # "newest" or "union" (models/local_ba.py)
        self.poses_r = [np.eye(3, dtype=np.float32)]
        self.poses_t = [np.zeros(3, np.float32)]
        self.stats: list[dict] = []
        self.on_metric = None
        self._feats = None
        self._depth = None
        self._scale = torch.ones((), device=self.device)
        self._last_rel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self._seed = ransac_cfg.seed
        self._key_ctr = 0
        self._ring: list[tuple] = []     # (desc, valid, pts) of the BA window
        self.vo_cfg = vo_cfg
        self.pg_cfg = pg_cfg
        self.n_kf = 0
        self.n_kf_total = 0              # keyframes ever inserted (monotonic)
        self.n_closures = 0
        self.n_gate_rejects = 0          # Sim(3) solves refused by sim3_gate
        self.gate_log: list[dict] = []   # per-solve gate observables
        self._kf_frame: list[int] = []   # frame index of each keyframe
        self._frame_ref: list[int] = []  # keyframe index each frame rides on
        self._ema_step = 0.0             # smoothed per-pair |t| (global units)
        self._kf_pose_r = self._kf_pose_t = None
        self._corr = None                # (cr, ct, cs): the accepted Sim(3) correction
        self._ref_feats = self._ref_depth = self._ref_pose = None
        if vo_cfg is not None:
            kf, n, dev = vo_cfg.max_keyframes, sift_cfg.total_kpts, self.device
            self._kf_desc = torch.zeros((kf, n, 128), device=dev)
            self._kf_valid = torch.zeros((kf, n), dtype=torch.bool, device=dev)
            self._kf_xyn = torch.zeros((kf, n, 2), device=dev)
            self._kf_depth = torch.zeros((kf, n), device=dev)
            # (i, j, meas_r, meas_t, meas_s, weight)
            self._edges: list[tuple] = []

    def _next_generators(self, n: int) -> list[torch.Generator]:
        self._key_ctr += 1
        return step_generators(self.device, self._seed, self._key_ctr, n)

    def _extract(self, dimg):
        f = extract(dimg, self.sift_cfg)
        if self._content is not None:
            f = mask_to_content(f, self._content, self.sift_cfg.border)
        return f

    def _xyn(self, f: SiftFeatures):
        return _normalised(f.x, f.y, self.intr)

    def process(self, img) -> dict | None:
        """Feed the next grayscale frame ([H, W] float in [0, 1]): a numpy
        array, or a tensor already on the device (`run`'s feeder)."""
        if isinstance(img, torch.Tensor):
            dimg = img.to(self.device)
        else:
            img = np.asarray(img, np.float32)
            if self.pad_to_tier:
                img, self._content = _pad_to_tier(img)
            dimg = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        if self._feats is None:
            self._feats = self._extract(dimg)
            n = self._feats.valid.shape[0]
            self._depth = torch.zeros(n, device=self.device)
            if self.ba_window:
                self._ring.append((self._feats.desc, self._feats.valid,
                                   torch.zeros((n, 3), device=self.device)))
            if self.vo_cfg is not None:
                self._insert_keyframe()     # frame 0 bootstraps the map
                self._frame_ref.append(0)
            return None
        gens = self._next_generators(2)
        kf_ref = self.vo_cfg is not None and self.vo_cfg.track_ref == "keyframe"
        fa, depth_a = ((self._ref_feats, self._ref_depth) if kf_ref
                       else (self._feats, self._depth))
        out, packed = pair_step(
            fa.desc, fa.valid, torch.stack([fa.x, fa.y], -1), depth_a, dimg, self.intr,
            self._scale, self.sift_cfg, self.match_cfg, self.ransac_cfg, gens,
            self._content, pnp_rescue=(self.vo_cfg.pnp_rescue if self.vo_cfg is not None
                                       else True))
        r_rel = packed[:9].reshape(3, 3)
        t_rel = packed[9:12]
        scale, n_inl, n_common, ok = packed[12:16]
        pnp_inl, pnp_ok = 0, False
        if packed[16] > 0.5:            # the PnP rescue supplied this pose
            pnp_ok, pnp_inl = True, int(n_inl)
        r_prev, t_prev = self.poses_r[-1], self.poses_t[-1]
        if kf_ref:
            # rel measures ref(keyframe) -> cur: compose onto the REFERENCE
            # pose, and keep the frame-to-frame relative for the carry
            if ok < 0.5:
                r_fr, t_fr = self._last_rel
                r_new = (r_fr @ r_prev).astype(np.float32)
                t_new = (r_fr @ t_prev + t_fr).astype(np.float32)
            else:
                ref_r, ref_t = self._ref_pose
                r_new = (r_rel @ ref_r).astype(np.float32)
                t_new = (r_rel @ ref_t + t_rel).astype(np.float32)
                r_fr = r_new @ r_prev.T
                self._last_rel = (r_fr, t_new - r_fr @ t_prev)
                self._scale = out.scale       # device-resident, no re-upload
            self.poses_r.append(r_new)
            self.poses_t.append(t_new)
        else:
            if ok < 0.5:
                r_rel, t_rel = self._last_rel        # constant velocity
            else:
                self._last_rel = (r_rel, t_rel)
                self._scale = out.scale
            self.poses_r.append((r_rel @ r_prev).astype(np.float32))
            self.poses_t.append((r_rel @ t_prev + t_rel).astype(np.float32))
        # depths triangulated from a REJECTED model are garbage: zero the
        # carried chain so the scale re-anchors from the next good pair,
        # and mask the frame's BA observations
        self._depth = out.depth if ok > 0.5 else torch.zeros_like(out.depth)
        ring_valid = out.feats.valid & (out.depth > 1e-6)
        if ok < 0.5:
            ring_valid = torch.zeros_like(ring_valid)
        # per-FRAME step (in keyframe-referenced mode t_rel spans ref -> cur)
        step = float(np.linalg.norm(self._last_rel[1] if kf_ref else t_rel))
        self._ema_step = (step if self._ema_step == 0.0
                          else 0.8 * self._ema_step + 0.2 * step)
        self._feats = out.feats
        if self.ba_window:
            self._ring.append((out.feats.desc, ring_valid, out.pts))
            self._ring = self._ring[-self.ba_window:]
            if (len(self._ring) == self.ba_window
                    and (len(self.poses_r) - 1) % self.ba_every == 0):
                self._window_ba()
        loop = False
        if self.vo_cfg is not None:
            self._frame_ref.append(max(self.n_kf - 1, 0))
            # keyframe-referenced mode never promotes a failed frame (it
            # would become the next tracking reference)
            if not kf_ref or ok >= 0.5:
                loop = self._maybe_keyframe()
        stat = dict(inliers=int(n_inl), scale=float(scale), scale_common=int(n_common),
                    ok=bool(ok > 0.5), pnp_inliers=pnp_inl, pnp_ok=pnp_ok,
                    map_s_med=float("nan"), map_n_anchor=0,
                    keyframe=bool(self.vo_cfg is not None and self._kf_frame
                                  and self._kf_frame[-1] == len(self.poses_r) - 1),
                    loop=loop)
        self.stats.append(stat)
        if self.on_metric:
            self.on_metric(stat)
        return stat

    # ---------- sequence-scale frontend (keyframes / loops / pose graph) ----

    def _evict_keyframe(self):
        """Free one keyframe-ring slot (`models/evict.py` with
        vo_cfg.kf_evict on the raw-chain centres); slot 0 and the newest 2
        slots are never evicted.  Returns the evicted slot or None."""
        victim = select_victim(self.vo_cfg.kf_evict, self._kf_pose_r, self._kf_pose_t,
                               self.n_kf, guard=2,
                               edges=((e[0], e[1], e[5]) for e in self._edges))
        if victim is None:
            return None
        self._remove_keyframe_slot(victim)
        return victim

    def _remove_keyframe_slot(self, v: int):
        """Remove ring slot v, shifting the slots above it down by one.

        Frames riding v inherit the previous keyframe's correction
        (`trajectory()` re-derives each frame's relative pose from the raw
        chain).  v's in and out edges compose into one Sim(3) edge (scales
        multiply, translations carry the upstream scale); other edges
        incident to v are dropped.
        """
        self._frame_ref = [r - 1 if r > v else (v - 1 if r == v else r)
                           for r in self._frame_ref]
        ins = [e for e in self._edges if e[1] == v and e[0] != v]
        outs = [e for e in self._edges if e[0] == v and e[1] != v]
        spliced = None
        if ins and outs:
            a, b = ins[0], outs[0]
            if a[0] != b[1]:
                # X_a = s1 R1 X_v + t1 and X_v = s2 R2 X_b + t2 compose to
                # X_a = (s1 s2)(R1 R2) X_b + s1 R1 t2 + t1
                spliced = (a[0], b[1], a[2] @ b[2], a[4] * (a[2] @ b[3]) + a[3],
                           a[4] * b[4], min(a[5], b[5]))

        def shift(x):
            return x - 1 if x > v else x

        self._edges = [(shift(e[0]), shift(e[1])) + e[2:]
                       for e in self._edges if e[0] != v and e[1] != v]
        if spliced is not None:
            self._edges.append((shift(spliced[0]), shift(spliced[1])) + spliced[2:])

        kfcap = self.vo_cfg.max_keyframes
        perm = np.concatenate([np.arange(v), np.arange(v + 1, kfcap), [v]])
        dperm = torch.from_numpy(perm).to(self.device)
        self._kf_desc = self._kf_desc[dperm]
        self._kf_valid = self._kf_valid[dperm]
        self._kf_xyn = self._kf_xyn[dperm]
        self._kf_depth = self._kf_depth[dperm]
        self._kf_pose_r = self._kf_pose_r[perm].copy()
        self._kf_pose_t = self._kf_pose_t[perm].copy()
        del self._kf_frame[v]
        if self._corr is not None:
            cr, ct, cs = self._corr
            self._corr = (np.concatenate([cr[perm[:-1]], np.eye(3, dtype=cr.dtype)[None]]),
                          np.concatenate([ct[perm[:-1]], np.zeros((1, 3), ct.dtype)]),
                          np.concatenate([cs[perm[:-1]], np.ones(1, cs.dtype)]))
        self.n_kf -= 1

    def _insert_keyframe(self) -> bool:
        """Promote the current frame into the keyframe ring (descriptors,
        normalised coordinates, chained depths) with the odometry edge to
        the previous keyframe.  At capacity a slot is evicted first; with
        eviction off, odometry goes on without map growth."""
        i = self.n_kf
        if i >= self.vo_cfg.max_keyframes:
            if self._evict_keyframe() is None:
                return False
            i = self.n_kf
        f = self._feats
        self._kf_desc[i] = f.desc
        self._kf_valid[i] = f.valid
        self._kf_xyn[i] = self._xyn(f)
        self._kf_depth[i] = torch.as_tensor(self._depth, device=self.device)
        if i == 0:
            kf = self.vo_cfg.max_keyframes
            self._kf_pose_r = np.broadcast_to(np.eye(3, dtype=np.float32), (kf, 3, 3)).copy()
            self._kf_pose_t = np.zeros((kf, 3), np.float32)
        r_new, t_new = self.poses_r[-1], self.poses_t[-1]
        self._kf_pose_r[i] = r_new
        self._kf_pose_t[i] = t_new
        if i > 0:
            # odometry edge prev -> i measured T_prev T_i^-1 (relative scale
            # 1: consecutive keyframes share the chain epoch)
            r_prev, t_prev = self._kf_pose_r[i - 1], self._kf_pose_t[i - 1]
            m_r = r_prev @ r_new.T
            self._edges.append((i - 1, i, m_r, t_prev - m_r @ t_new, 1.0, 1.0))
        if self._corr is not None and i > 0:
            # compose the new keyframe onto the CORRECTED map: inherit the
            # predecessor's correction through the raw relative motion
            cr, ct, cs = self._corr
            r_rel = r_new @ self._kf_pose_r[i - 1].T
            t_rel = t_new - r_rel @ self._kf_pose_t[i - 1]
            cr[i] = r_rel @ cr[i - 1]
            ct[i] = r_rel @ ct[i - 1] + t_rel
            cs[i] = cs[i - 1]
        self._kf_frame.append(len(self.poses_r) - 1)
        self.n_kf = i + 1
        self.n_kf_total += 1
        if self.vo_cfg.track_ref == "keyframe":
            # the promoted frame becomes the tracking reference; the next
            # pair spans one frame, so the scale clamp restarts from the
            # per-frame step (1.0 at bootstrap, the |t01| = 1 anchor)
            self._ref_feats = f
            self._ref_depth = self._depth
            self._ref_pose = (np.array(r_new), np.array(t_new))
            self._scale = torch.tensor(np.float32(self._ema_step if self._ema_step > 0 else 1.0),
                                       device=self.device)
        return True

    def _maybe_keyframe(self) -> bool:
        """Keyframe promotion + loop closure; returns True on a closure."""
        cfg = self.vo_cfg
        if self.n_kf == 0:
            self._insert_keyframe()
            return False
        if cfg.track_ref == "keyframe" and self.n_kf == 1:
            # force the SECOND keyframe on the first tracked frame: until
            # the reference carries depth, no pair can measure the scale
            if not self._insert_keyframe():
                return False
            self._frame_ref[-1] = self.n_kf - 1
            return self._try_loop_closure()
        last = self._kf_frame[-1]
        cur = len(self.poses_r) - 1
        r_kf, t_kf = self._kf_pose_r[self.n_kf - 1], self._kf_pose_t[self.n_kf - 1]
        r_cur, t_cur = self.poses_r[-1], self.poses_t[-1]
        ang = float(np.arccos(np.clip((np.trace(r_cur @ r_kf.T) - 1) / 2, -1.0, 1.0)))
        dist = float(np.linalg.norm(-(r_cur.T @ t_cur) + r_kf.T @ t_kf))
        # translation gate in multiples of the smoothed per-pair step
        trans_gate = cfg.kf_min_translation * max(self._ema_step, 1e-12)
        if cur - last < cfg.kf_every and ang < cfg.kf_min_rotation and dist < trans_gate:
            return False
        if not self._insert_keyframe():
            return False
        self._frame_ref[-1] = self.n_kf - 1
        return self._try_loop_closure()

    def _try_loop_closure(self) -> bool:
        """Retrieve + verify + Sim(3)-optimise for the newest keyframe."""
        cfg = self.vo_cfg
        j = self.n_kf - 1
        exclude_lo = j - cfg.loop_temporal_gap
        if exclude_lo <= 0:
            return False
        f = self._feats
        packed = _loop_verify_step(
            f.desc, f.valid, self._xyn(f), self._depth, self._kf_desc, self._kf_valid,
            self._kf_xyn, self._kf_depth, exclude_lo, cfg.loop_min_score,
            cfg.loop_min_inliers, cfg.loop_min_common, self.match_cfg, self.ransac_cfg,
            self._next_generators(3)).cpu().numpy()             # the one fetch
        cand, score, ok, inl = (int(packed[0]), float(packed[1]), bool(packed[2] > 0.5),
                                int(packed[3]))
        n_b, med_b, n_a, med_a = (int(packed[4]), float(packed[5]), int(packed[6]),
                                  float(packed[7]))
        if (not ok or not np.isfinite(score) or score < cfg.loop_min_score
                or inl < cfg.loop_min_inliers or min(n_b, n_a) < cfg.loop_min_common
                or not np.isfinite(med_b) or med_b <= 1e-6
                or not np.isfinite(med_a) or med_a <= 1e-6):
            return False
        # Sim(3) edge cand -> j: X_cand = s_m R X_j + t, s_m = k_cand / k_cur,
        # t in the candidate's epoch
        self._edges.append((cand, j, packed[8:17].reshape(3, 3).astype(np.float32),
                            (packed[17:20] * med_b).astype(np.float32), med_b / med_a, 2.0))
        self.n_closures += 1
        self._optimize_graph()
        return True

    @staticmethod
    def _speed_dispersion(pose_r: np.ndarray, pose_t: np.ndarray,
                          scales: np.ndarray | None, frames: list[int]) -> float:
        """Std of log per-keyframe-segment camera speed (gate observable);
        with `scales`, centres of the corrected similarity (R_i, t_i / s_i)."""
        n = len(frames)
        if n < 5:
            return 0.0
        t = pose_t[:n] / (np.maximum(scales[:n], 1e-12)[:, None] if scales is not None
                          else 1.0)
        c = -np.einsum("nij,nj->ni", np.transpose(pose_r[:n], (0, 2, 1)), t)
        gaps = np.maximum(np.diff(np.asarray(frames, np.float64)), 1.0)
        v = np.linalg.norm(np.diff(c, axis=0), axis=1) / gaps
        v = v[v > 1e-12]
        if v.size < 4:
            return 0.0
        return float(np.std(np.log(v)))

    @staticmethod
    def _correction_roughness(pose_r: np.ndarray, pose_t: np.ndarray, corr: tuple,
                              frames: list[int]) -> float:
        """std(diff(log(v_corr / v_raw))) per keyframe segment: the
        motion-free roughness of the speed change a correction applies
        (0.0 when too short)."""
        n = len(frames)
        if n < 5:
            return 0.0
        cr, ct, cs = corr
        c_raw = -np.einsum("nij,nj->ni", np.transpose(pose_r[:n], (0, 2, 1)), pose_t[:n])
        t_cor = ct[:n] / np.maximum(cs[:n], 1e-12)[:, None]
        c_cor = -np.einsum("nij,nj->ni", np.transpose(cr[:n], (0, 2, 1)), t_cor)
        v_raw = np.linalg.norm(np.diff(c_raw, axis=0), axis=1)
        v_cor = np.linalg.norm(np.diff(c_cor, axis=0), axis=1)
        ok = (v_raw > 1e-12) & (v_cor > 1e-12)
        if np.count_nonzero(ok) < 4:
            return 0.0
        return float(np.std(np.diff(np.log(v_cor[ok]) - np.log(v_raw[ok]))))

    def _gate_accept(self, sig_raw: float, sig_corr: float, sig_delta: float) -> bool:
        """Sim(3) solve health (VOConfig.sim3_gate): rejected only when both
        the speed route (corrected log-speed dispersion within
        sim3_gate_margin of raw's) and the smoothness route (roughness
        under sim3_gate_smooth) say unhealthy."""
        if self.vo_cfg.sim3_gate != "speed":
            return True
        speed_ok = sig_raw <= 0.0 or sig_corr <= sig_raw * self.vo_cfg.sim3_gate_margin
        return speed_ok or sig_delta <= self.vo_cfg.sim3_gate_smooth

    def _optimize_graph(self):
        """Sim(3) pose graph over the raw keyframe chain, from unit node
        scales every time (repeated closures re-derive, not re-apply, the
        correction); stored as the correction `trajectory()` composes, if
        the gate accepts it.  Edges are padded with weight-0 identities to
        a multiple of 64; two packed uploads, one packed fetch.

        The reference solves over the whole ring; slots at and above n_kf
        have no edge, so their step is exactly 0 and their rows of the
        correction stay (R_i, t_i, 1): the solve here covers the n_kf live
        slots and fills the rest so.
        """
        e = len(self._edges)
        cap = max(64, -(-e // 64) * 64)
        pad = cap - e
        n = self.n_kf
        iblob = torch.from_numpy(np.concatenate(
            [np.array([x[0] for x in self._edges], np.int64), np.zeros(pad, np.int64),
             np.array([x[1] for x in self._edges], np.int64), np.zeros(pad, np.int64)]
        )).to(self.device)
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3))
        fblob = torch.from_numpy(np.concatenate([
            self._kf_pose_r[:n].ravel(), self._kf_pose_t[:n].ravel(),
            np.concatenate([np.stack([x[2] for x in self._edges]), eye]).ravel(),
            np.concatenate([np.stack([x[3] for x in self._edges]),
                            np.zeros((pad, 3), np.float32)]).ravel(),
            np.array([x[4] for x in self._edges], np.float32), np.ones(pad, np.float32),
            np.array([x[5] for x in self._edges], np.float32), np.zeros(pad, np.float32),
        ]).astype(np.float32)).to(self.device)
        pr, pt, mr, mt, ms, wt = torch.split(fblob, (n * 9, n * 3, cap * 9, cap * 3, cap, cap))
        g = Sim3Graph(poses_r=pr.reshape(n, 3, 3), poses_t=pt.reshape(n, 3),
                      poses_s=torch.ones(n, device=self.device),
                      edge_i=iblob[:cap], edge_j=iblob[cap:],
                      meas_r=mr.reshape(cap, 3, 3), meas_t=mt.reshape(cap, 3),
                      meas_s=ms, weight=wt)
        res = sim3_optimize(g, self.pg_cfg)
        packed = torch.cat([res.poses_r.reshape(-1), res.poses_t.reshape(-1), res.poses_s]
                           ).cpu().numpy()                    # the one fetch
        kf = self._kf_pose_r.shape[0]
        corr = (self._kf_pose_r.copy(), self._kf_pose_t.copy(), np.ones(kf, np.float32))
        corr[0][:n] = packed[:n * 9].reshape(n, 3, 3)
        corr[1][:n] = packed[n * 9:n * 12].reshape(n, 3)
        corr[2][:n] = packed[n * 12:]
        sig_raw = self._speed_dispersion(self._kf_pose_r, self._kf_pose_t, None, self._kf_frame)
        sig_corr = self._speed_dispersion(corr[0], corr[1], corr[2], self._kf_frame)
        sig_delta = self._correction_roughness(self._kf_pose_r, self._kf_pose_t, corr,
                                               self._kf_frame)
        accept = self._gate_accept(sig_raw, sig_corr, sig_delta)
        self.gate_log.append(dict(frame=len(self.poses_r) - 1, sig_raw=round(sig_raw, 4),
                                  sig_corr=round(sig_corr, 4), sig_delta=round(sig_delta, 4),
                                  accept=bool(accept)))
        if accept:
            self._corr = corr
        else:
            self.n_gate_rejects += 1

    def trajectory(self) -> tuple:
        """Per-frame world-to-camera poses with the latest loop correction:
        keyframe i maps to (R_i, t_i / s_i), every frame rides its reference
        keyframe with its raw relative translation in the corrected epoch.
        Without a correction, the raw chain."""
        if self._corr is None:
            return np.stack(self.poses_r), np.stack(self.poses_t)
        cr, ct, cs = self._corr
        rs, ts = [], []
        for k, ref in enumerate(self._frame_ref):
            r_kf, t_kf = self._kf_pose_r[ref], self._kf_pose_t[ref]
            rel_r = self.poses_r[k] @ r_kf.T
            rel_t = (self.poses_t[k] - rel_r @ t_kf) / max(cs[ref], 1e-12)
            r_c, t_c = cr[ref], ct[ref] / max(cs[ref], 1e-12)
            rs.append((rel_r @ r_c).astype(np.float32))
            ts.append((rel_r @ t_c + rel_t).astype(np.float32))
        return np.stack(rs), np.stack(ts)

    def _window_ba(self):
        """Bundle-adjust the last W frames over their triangulated depths
        (`models/local_ba.py:window_ba`, the two oldest poses fixing the
        scale-inclusive gauge): one upload of the window poses, one packed
        fetch."""
        w = self.ba_window
        kd = torch.stack([r[0] for r in self._ring])
        kv = torch.stack([r[1] for r in self._ring])
        kp = torch.stack([r[2] for r in self._ring])
        idxs = np.arange(len(self.poses_r) - w, len(self.poses_r))
        blob = torch.from_numpy(np.concatenate(
            [np.stack([self.poses_r[i] for i in idxs]).ravel(),
             np.stack([self.poses_t[i] for i in idxs]).ravel()]).astype(np.float32)
        ).to(self.device)
        ba_cfg = BAConfig(max_iters=4, cg_iters=12, num_fixed_poses=2, huber_delta=4.0)
        args = (kd, kv, kp, blob[:w * 9].reshape(w, 3, 3), blob[w * 9:].reshape(w, 3),
                self.intr, torch.ones(w, device=self.device))
        if self._ba_mesh is not None and self.ba_anchor == "newest":
            from ..parallel.dist_ba import window_ba_dist
            r, t, c0, c1 = window_ba_dist(*args, self._ba_mesh, self.match_cfg, ba_cfg)
        else:
            # "union" anchoring stays single-device (see models/slam.py)
            r, t, c0, c1 = window_ba(*args, self.match_cfg, ba_cfg, anchor=self.ba_anchor)
        packed = torch.cat([r.reshape(-1), t.reshape(-1), torch.stack([c0, c1])]
                           ).cpu().numpy()                    # the one fetch
        rs = packed[:w * 9].reshape(w, 3, 3)
        ts = packed[w * 9:w * 12].reshape(w, 3)
        for k, i in enumerate(idxs):
            self.poses_r[i] = rs[k].astype(np.float32)
            self.poses_t[i] = ts[k].astype(np.float32)
        # keyframe-referenced tracking composes from the FROZEN reference
        # pose: refresh it when BA just moved the reference frame
        if (self.vo_cfg is not None and self.vo_cfg.track_ref == "keyframe"
                and self._kf_frame and self._kf_frame[-1] in set(idxs)):
            f_idx = self._kf_frame[-1]
            self._ref_pose = (self.poses_r[f_idx].copy(), self.poses_t[f_idx].copy())
        self._last_ba = (float(packed[-2]), float(packed[-1]))

    # ---------- checkpoint / resume ----------

    def checkpoint(self, path: str):
        """The whole tracking state as one .npz, with the keys of the
        reference's checkpoint (either package restores the other's);
        `stats` is metrics, not state, and is not saved."""
        np.savez_compressed(path, **mono_checkpoint_arrays(self))

    def restore(self, path: str):
        """Restore a `checkpoint` into this identically-configured VO."""
        with np.load(path) as z:
            fields = mono_state_fields(z, self.device, self.vo_cfg is not None)
        for name, value in fields.items():
            setattr(self, name, value)

    def run(self, frames, max_frames: int | None = None) -> tuple:
        """Process an iterable of [H, W] numpy frames; returns
        `trajectory()`.  A feeder thread uploads frame i+1 while frame i
        runs (`utils/pipeline.py`); with `pad_to_tier` the frames are
        padded on the host and fed one by one."""
        if self.pad_to_tier:
            for i, img in enumerate(frames):
                if max_frames is not None and i >= max_frames:
                    break
                self.process(img)
            return self.trajectory()
        host = ((np.asarray(img, np.float32), None) for img in frames)
        for i, (dimg, _) in enumerate(_uploaded(host, self.device, 2)):
            if max_frames is not None and i >= max_frames:
                break
            self.process(dimg)
        return self.trajectory()

"""Keyframe RGB-D SLAM: tracking, keyframing, window BA, loop closure,
pose graph, eviction and relocalisation (twin of
`cusift_tpu/models/slam.py`).

Each frame is one tracking step on the device: extraction (kernel K1 in
every octave), matching against the reference keyframe (kernel K2) and
rigid RANSAC, packed into ONE [22] float tensor that the host copies once
to take its decisions (keyframe promotion, relocalisation).  The keyframe
store is a fixed-capacity ring of descriptor/validity/point tensors on the
device (256 x N x 128 float32 at the defaults); poses and the pose-graph
edges live on the host.

A keyframe insert runs the backend event.  The fused form
(`_kf_event_step`, the default) does window BA and loop-closure retrieval
+ geometric verification in one step with one packed upload (the window
poses) and one packed fetch; when that fetch says the closure was
accepted, the host appends the edge and runs the dense pose-graph solve
(`_optimize_graph`), so a closing event pays one more upload and fetch and
a non-closing one pays no graph solve at all.  The reference branches on
the device instead (`lax.cond`); the results are the same.  The split form
(`_local_ba`, `_try_loop_closure`, `_optimize_graph`) runs the same steps
one by one.  With `defer_events` the event's fetch waits until the next
reader of the pose/edge state.

`run(chunk=N)` tracks N frames a step against one reference keyframe
(`_chunk_step`: one `extract_batch` over the N images, then matching and
RANSAC frame by frame) and copies the [N, 22] rows to the host once; the
host then commits the frames in order, re-gating keyframe promotion
against any keyframe inserted earlier in the chunk.  Row i equals
`_frame_step` of frame i against the same reference with the same
generator, to the bit.

Randomness: each RANSAC call gets its own `torch.Generator`, seeded from
(seed, counter) as the reference derives one threefry key per call, so
checkpoints keep the key's meaning.  `dist_ba=True` waits for the
distributed BA and raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import (BAConfig, MatchConfig, PoseGraphConfig, RansacConfig,
                      SiftConfig, SlamConfig)
from ..convert import slam_checkpoint_arrays, slam_state_fields
from ..data.evaluation import ate_rmse
from ..ops.geometry import backproject
from ..ops.match import match
from ..ops.ransac import find_rigid, step_generators
from ..optim.lie import inverse, se3_log
from ..optim.posegraph import PoseGraph, optimize as pg_optimize
from ..utils.device import as_input, run_device
from ..utils.pipeline import device_chunks, device_frames
from ..utils.precision import f32_matmuls
from .evict import select_victim
from .local_ba import window_ba
from .sift import SiftFeatures, extract, extract_batch
from .twoview import depth_at

# keyframes scored per batched matmul in `_kf_scores`: [16, N, N] float32
# similarities, 268 MB at N = 2048
_SCORE_BLOCK = 16


def _f32(*xs) -> torch.Tensor:
    """Scalars (tensors or numbers) as one float32 vector on the first
    tensor's device."""
    dev = next(x.device for x in xs if isinstance(x, torch.Tensor))
    return torch.stack([torch.as_tensor(x, device=dev).to(torch.float32) for x in xs])


def _frame_of(feats: SiftFeatures, i: int) -> SiftFeatures:
    """Frame i of a batched feature set."""
    return SiftFeatures(*(a[i] for a in feats))


def _backproject_features(f: SiftFeatures, depth, intr):
    """Camera-frame 3D points of the features (z = 0 where invalid) and
    their validity."""
    d = depth_at(depth, f.x, f.y) * f.valid
    pts = backproject(torch.stack([f.x, f.y], -1), d, intr[0], intr[1], intr[2], intr[3])
    return pts, (d > 1e-6) & f.valid


def _extract_with_points(img, depth, intr, sift_cfg: SiftConfig):
    """Features + camera-frame 3D backprojections (z = 0 where invalid)."""
    f = extract(img, sift_cfg)
    return (f, *_backproject_features(f, depth, intr))


def _track(desc_a, valid_a, pts_a, desc_b, valid_b, pts_b,
           match_cfg: MatchConfig, ransac_cfg: RansacConfig, generator):
    """Match frame A to frame B and fit rigid T with pts_b ~ R pts_a + t."""
    m = match(desc_a, valid_a, desc_b, valid_b, match_cfg)
    pb = pts_b[m.idx.long()]
    ok = m.ok & valid_a & (pts_a[:, 2] > 1e-6) & (pb[:, 2] > 1e-6)
    return find_rigid(pts_a, pb, ok, ransac_cfg, generator), m


def _tracking_row(f: SiftFeatures, pts, pvalid, ref_desc, ref_valid, ref_pts,
                  match_cfg: MatchConfig, ransac_cfg: RansacConfig, generator):
    """Match + rigid RANSAC of one frame against the reference keyframe,
    with the keyframe-decision scalars packed into ONE [22] float tensor
    [inliers, ok, kpts, matches | rel_r 9 | rel_t 3 | xi 6]."""
    m = match(f.desc, f.valid, ref_desc, ref_valid, match_cfg)
    pb = ref_pts[m.idx.long()]
    ok = m.ok & pvalid & (pb[:, 2] > 1e-6)
    rig = find_rigid(pts, pb, ok, ransac_cfg, generator)
    # rig: X_ref = R X_cur + t  =>  T_cur<-ref = (R, t)^-1
    rel_r, rel_t = inverse(rig.r, rig.t)
    xi = se3_log(rel_r, rel_t)
    return torch.cat([_f32(rig.num_inliers, rig.ok, f.valid.sum(), m.ok.sum()),
                      rel_r.reshape(-1), rel_t, xi])


@f32_matmuls
def _frame_step(img, depth, intr, ref_desc, ref_valid, ref_pts,
                sift_cfg: SiftConfig, match_cfg: MatchConfig,
                ransac_cfg: RansacConfig, generator):
    """One tracking step: extract + match + rigid RANSAC + the
    keyframe-decision scalars (`_tracking_row`)."""
    f, pts, pvalid = _extract_with_points(img, depth, intr, sift_cfg)
    return f, pts, _tracking_row(f, pts, pvalid, ref_desc, ref_valid, ref_pts,
                                 match_cfg, ransac_cfg, generator)


@f32_matmuls
def _chunk_step(frames, intr, ref_desc, ref_valid, ref_pts,
                sift_cfg: SiftConfig, match_cfg: MatchConfig,
                ransac_cfg: RansacConfig, generators):
    """Track a [N, 2, H, W] chunk of (image, depth) frames against ONE
    reference keyframe: one `extract_batch` over the N images, then each
    frame's backprojection, match and rigid RANSAC with its own generator.

    Returns the batched features, the points [N, K, 3] and the packed rows
    [N, 22], the one tensor the host copies per chunk.  Row i equals
    `_frame_step` of frame i with generator i.
    """
    feats = extract_batch(frames[:, 0].contiguous(), sift_cfg)
    pts, rows = [], []
    for i, gen in enumerate(generators):
        f = _frame_of(feats, i)
        p, pvalid = _backproject_features(f, frames[i, 1], intr)
        rows.append(_tracking_row(f, p, pvalid, ref_desc, ref_valid, ref_pts,
                                  match_cfg, ransac_cfg, gen))
        pts.append(p)
    return feats, torch.stack(pts), torch.stack(rows)


@f32_matmuls
def _kf_scores(query_desc, query_valid, kf_desc, kf_valid, kf_active,
               limit: int | None = None):
    """[KF] similarity of a query frame to every stored keyframe.

    Mean best correlation over the valid query descriptors (the
    bag-of-features retrieval proxy), -inf where kf_active is false.  The
    [KF, N, M] similarity is never materialised: keyframes are scored in
    blocks of `_SCORE_BLOCK` by a batched matmul and a max.  `limit`
    (host-known) skips slots >= limit, which the caller's kf_active
    already marks inactive.
    """
    kfcap = kf_desc.shape[0]
    n_score = kfcap if limit is None else max(0, min(limit, kfcap))
    count = query_valid.sum().to(torch.float32).clamp(min=1.0)
    parts = []
    for b0 in range(0, n_score, _SCORE_BLOCK):
        b1 = min(b0 + _SCORE_BLOCK, n_score)
        sim = torch.matmul(query_desc, kf_desc[b0:b1].transpose(1, 2))    # [B, N, M]
        sim = torch.where(kf_valid[b0:b1, None, :], sim,
                          torch.full_like(sim, -torch.inf))
        best = sim.amax(-1)                                              # [B, N]
        best = torch.where(query_valid[None, :] & torch.isfinite(best), best,
                           torch.zeros_like(best))
        parts.append(best.sum(-1) / count)
    scores = query_desc.new_full((kfcap,), -torch.inf)
    if parts:
        scores[:n_score] = torch.cat(parts)
    return torch.where(kf_active, scores, torch.full_like(scores, -torch.inf))


@f32_matmuls
def _retrieve_verify_step(desc, valid, pts, kf_desc, kf_valid, kf_pts,
                          limit: int, exclude: int,
                          match_cfg: MatchConfig, ransac_cfg: RansacConfig,
                          generator):
    """Retrieval + geometric verification of the best map candidate, one
    packed [16] result [cand, score, ok, inliers | R 9 | t 3]; shared by
    loop closure and relocalisation."""
    idx = torch.arange(kf_desc.shape[0], device=desc.device)
    active = (idx < limit) & (idx != exclude)
    scores = _kf_scores(desc, valid, kf_desc, kf_valid, active, limit)
    cand = torch.argmax(scores)
    rig, _ = _track(desc, valid, pts, kf_desc[cand], kf_valid[cand], kf_pts[cand],
                    match_cfg, ransac_cfg, generator)
    return torch.cat([_f32(cand, scores[cand], rig.ok, rig.num_inliers),
                      rig.r.reshape(-1), rig.t])


@f32_matmuls
def _kf_event_step(kf_desc, kf_valid, kf_pts, intr, blob, generator,
                   j: int, n_kf: int, lim: int, w: int,
                   match_cfg: MatchConfig, ransac_cfg: RansacConfig,
                   ba_cfg: BAConfig, min_score: float, min_inl: int):
    """The keyframe-insert backend as one step: window BA over ring slots
    [n_kf - w, n_kf), then loop-closure retrieval over slots < lim and
    geometric verification of the best candidate against keyframe j.

    blob: the window poses [r w*9 | t w*3] (the one upload).  Returns the
    one blob the host fetches: [r w*9 | t w*3 | cand score accept inl
    ba_c0 ba_c1 | rig_r 9 | rig_t 3].  The gates the reference evaluates
    on the device (n_kf >= w, lim > 0) are host ints here.
    """
    dev = blob.device
    pr = blob[:w * 9].reshape(w, 3, 3)
    pt = blob[w * 9:w * 12].reshape(w, 3)
    zero_c = torch.zeros((), dtype=torch.float32, device=dev)
    ba_c0 = ba_c1 = zero_c
    if 3 <= w <= n_kf:
        win = slice(n_kf - w, n_kf)
        pr, pt, ba_c0, ba_c1 = window_ba(
            kf_desc[win], kf_valid[win], kf_pts[win], pr, pt, intr,
            torch.ones(w, dtype=torch.float32, device=dev), match_cfg, ba_cfg)

    if lim > 0:
        active = torch.arange(kf_desc.shape[0], device=dev) < lim
        scores = _kf_scores(kf_desc[j], kf_valid[j], kf_desc, kf_valid, active, lim)
        cand = torch.argmax(scores)
        rig, _ = _track(kf_desc[j], kf_valid[j], kf_pts[j], kf_desc[cand],
                        kf_valid[cand], kf_pts[cand], match_cfg, ransac_cfg, generator)
        score, rv_ok, inl = scores[cand], rig.ok, rig.num_inliers.to(torch.float32)
        rig_r, rig_t = rig.r, rig.t
        accept = (rv_ok & torch.isfinite(score) & (score >= min_score)
                  & (inl >= min_inl))
    else:
        cand = torch.zeros((), dtype=torch.int64, device=dev)
        score = torch.full((), -torch.inf, device=dev)
        inl = zero_c
        accept = torch.zeros((), dtype=torch.bool, device=dev)
        rig_r = torch.eye(3, device=dev)
        rig_t = torch.zeros(3, device=dev)
    return torch.cat([pr.reshape(-1), pt.reshape(-1),
                      _f32(cand, score, accept, inl, ba_c0, ba_c1),
                      rig_r.reshape(-1), rig_t])


@dataclasses.dataclass
class SlamState:
    """Fixed-capacity SLAM map: the keyframe ring on the device, poses and
    edges on the host."""

    kf_desc: torch.Tensor     # [KF, N, 128]
    kf_valid: torch.Tensor    # [KF, N]
    kf_pts: torch.Tensor      # [KF, N, 3] camera-frame backprojections
    kf_pose_r: np.ndarray     # [KF, 3, 3] world-to-camera
    kf_pose_t: np.ndarray     # [KF, 3]
    n_kf: int
    # pose-graph edges (host lists; bounded by frames processed)
    edge_i: list
    edge_j: list
    meas_r: list
    meas_t: list
    weight: list
    # trajectory: per processed frame (ref_kf, T_cur<-kf as (R, t), tracked)
    traj_ref: list
    traj_rel_r: list
    traj_rel_t: list
    traj_ok: list
    n_closures: int = 0
    n_kf_total: int = 0       # keyframes ever inserted (n_kf pins at capacity)


class Slam:
    """Sequential RGB-D SLAM (BASELINE configs[3]).

    The map and every per-frame step live on `device` ("cuda" unless the
    caller asks for "cpu"); numpy frames are copied there.
    """

    def __init__(self, intr, sift_cfg=SiftConfig(), match_cfg=MatchConfig(),
                 ransac_cfg=RansacConfig(), slam_cfg=SlamConfig(),
                 pg_cfg=PoseGraphConfig(), seed: int = 0,
                 dist_ba: bool = False, *, device=None):
        if dist_ba:
            raise NotImplementedError("Slam(dist_ba=True): the distributed window "
                                      "BA is not ported yet (ROADMAP queue 1, item 12)")
        self.device = run_device(device, "Slam")
        self.intr = torch.as_tensor(np.asarray(intr), dtype=torch.float32,
                                    device=self.device)
        self.sift_cfg = sift_cfg
        self.match_cfg = match_cfg
        self.ransac_cfg = ransac_cfg
        self.cfg = slam_cfg
        self.pg_cfg = pg_cfg
        self._seed = seed
        self._key_ctr = 0
        n = sift_cfg.total_kpts
        kf = slam_cfg.max_keyframes
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (kf, 3, 3)).copy()
        dev = self.device
        self.state = SlamState(
            kf_desc=torch.zeros((kf, n, 128), device=dev),
            kf_valid=torch.zeros((kf, n), dtype=torch.bool, device=dev),
            kf_pts=torch.zeros((kf, n, 3), device=dev), kf_pose_r=eye,
            kf_pose_t=np.zeros((kf, 3), np.float32), n_kf=0,
            edge_i=[], edge_j=[], meas_r=[], meas_t=[], weight=[],
            traj_ref=[], traj_rel_r=[], traj_rel_t=[], traj_ok=[])
        self.metrics: list[dict] = []
        # deferred fused event: [j, packed device result, metric record, lo, w]
        self._pending_event: list | None = None
        # deferral serves the sequential path only; a chunked run turns it off
        self._defer_ok = True
        # a chunked run's in-flight reference slot, [slot] (see _run_chunked)
        self._chunk_ref: list | None = None
        # the last keyframe inserted in the current chunk, as its pose
        # relative to the chunk's reference (re-gates promotion in _commit)
        self._chunk_last_insert: tuple | None = None
        # optional per-frame callback, called with each committed record
        self.on_metric = None
        # optional callback on fused keyframe events: on_event("dispatch", j)
        # before event j's step is enqueued, on_event("enqueued", j) after,
        # and on_event("applied", record) once its result is applied (the
        # record: keyframe slot, window size, window BA's initial and final cost,
        # closure accepted, host ms of the apply with any graph solve)
        self.on_event = None
        self._fused_events = (slam_cfg.fused_events
                              and slam_cfg.local_ba_anchor == "newest")
        self._ba_cfg = BAConfig(max_iters=slam_cfg.local_ba_iters,
                                cg_iters=slam_cfg.local_ba_cg_iters,
                                num_fixed_poses=2, huber_delta=4.0)
        self._pg_dense = dataclasses.replace(pg_cfg, solver="dense")

    # ---------- keyframe management ----------

    def _add_keyframe(self, desc, valid, pts, pose_r, pose_t) -> int:
        s = self.state
        i = s.n_kf
        if i >= self.cfg.max_keyframes:
            raise RuntimeError("keyframe capacity exceeded")
        s.kf_desc[i] = desc
        s.kf_valid[i] = valid
        s.kf_pts[i] = pts
        s.kf_pose_r[i] = np.asarray(pose_r)
        s.kf_pose_t[i] = np.asarray(pose_t)
        s.n_kf = i + 1
        s.n_kf_total += 1
        # the new reference's views, by value (the inserted tensors)
        self._ref_cache = (i, desc, valid, pts)
        return i

    def _evict_keyframe(self):
        """Free one ring slot for a new keyframe; returns the slot or None.

        Victim policy: `models/evict.py` with cfg.kf_evict.  Slot 0 (the
        gauge origin), the newest `local_ba_window` slots and a chunked
        run's in-flight reference (its frames' rows resolve through that
        slot) are never evicted.
        """
        s = self.state
        victim = select_victim(
            self.cfg.kf_evict, s.kf_pose_r, s.kf_pose_t, s.n_kf,
            guard=max(self.cfg.local_ba_window, 2),
            edges=zip(s.edge_i, s.edge_j, s.weight),
            pinned=self._chunk_ref[0] if self._chunk_ref is not None else -1)
        if victim is None:
            return None
        self._remove_keyframe_slot(victim)
        return victim

    def _remove_keyframe_slot(self, v: int):
        """Remove ring slot v, shifting slots above it down by one.

        Keeps slot index == temporal order.  Trajectory frames referenced
        to v are baked to ABSOLUTE world-to-camera poses at its current
        estimate and marked ref = -1; v's in/out edges are spliced into
        one composed edge; remaining edges incident to v are dropped.
        """
        s = self.state
        rv, tv = s.kf_pose_r[v].copy(), s.kf_pose_t[v].copy()
        for i, ref in enumerate(s.traj_ref):
            if ref == v:
                s.traj_rel_t[i] = s.traj_rel_r[i] @ tv + s.traj_rel_t[i]
                s.traj_rel_r[i] = s.traj_rel_r[i] @ rv
                s.traj_ref[i] = -1
            elif ref > v:
                s.traj_ref[i] = ref - 1

        ins = [k for k in range(len(s.edge_i))
               if s.edge_j[k] == v and s.edge_i[k] != v]
        outs = [k for k in range(len(s.edge_i))
                if s.edge_i[k] == v and s.edge_j[k] != v]
        spliced = None
        if ins and outs:
            a, b = ins[0], outs[0]
            if s.edge_i[a] != s.edge_j[b]:
                spliced = (s.edge_i[a], s.edge_j[b],
                           s.meas_r[a] @ s.meas_r[b],
                           s.meas_r[a] @ s.meas_t[b] + s.meas_t[a],
                           min(s.weight[a], s.weight[b]))
        keep = [k for k in range(len(s.edge_i))
                if s.edge_i[k] != v and s.edge_j[k] != v]

        def shift(x):
            return x - 1 if x > v else x

        s.edge_i = [shift(s.edge_i[k]) for k in keep]
        s.edge_j = [shift(s.edge_j[k]) for k in keep]
        s.meas_r = [s.meas_r[k] for k in keep]
        s.meas_t = [s.meas_t[k] for k in keep]
        s.weight = [s.weight[k] for k in keep]
        if spliced is not None:
            self._add_edge(shift(spliced[0]), shift(spliced[1]),
                           spliced[2], spliced[3], spliced[4])

        # the ring permutation: slots above v move down one, v's stale data
        # parks in the top slot until the next insert overwrites it
        kfcap = self.cfg.max_keyframes
        pnp = np.concatenate([np.arange(v), np.arange(v + 1, kfcap), [v]])
        perm = torch.from_numpy(pnp).to(self.device)
        s.kf_desc = s.kf_desc[perm]
        s.kf_valid = s.kf_valid[perm]
        s.kf_pts = s.kf_pts[perm]
        s.kf_pose_r = s.kf_pose_r[pnp].copy()
        s.kf_pose_t = s.kf_pose_t[pnp].copy()
        s.n_kf -= 1
        ref = self._ref_cache[0]
        if ref > v:        # cached views are by value; only the index moves
            self._ref_cache = (ref - 1,) + self._ref_cache[1:]
        if self._chunk_ref is not None and self._chunk_ref[0] > v:
            self._chunk_ref[0] -= 1     # never == v: eviction pins it

    def _add_edge(self, i, j, rel_r, rel_t, weight=1.0):
        """Edge constraint: measured T_i * T_j^-1 (world-to-cam convention)."""
        s = self.state
        s.edge_i.append(int(i))
        s.edge_j.append(int(j))
        s.meas_r.append(np.asarray(rel_r))
        s.meas_t.append(np.asarray(rel_t))
        s.weight.append(float(weight))

    def _next_key(self) -> torch.Generator:
        """A fresh generator for one RANSAC call, seeded from (seed, counter)
        (`ops/ransac.py:step_generators`)."""
        self._key_ctr += 1
        return step_generators(self.device, self._seed, self._key_ctr)[0]

    def _next_keys(self, n: int) -> list[torch.Generator]:
        """n fresh generators, as n calls of `_next_key` give them."""
        return [self._next_key() for _ in range(n)]

    # ---------- main loop ----------

    def process_frame(self, img, depth) -> dict:
        """Track one RGB-D frame; returns per-frame metrics.

        One tracking step + one [22]-float fetch per frame.  The per-frame
        API keeps eager semantics (any deferred event is applied before it
        returns); `run` streams instead.
        """
        if self.state.n_kf == 0:
            return self._bootstrap(img, depth)
        rec = self._commit(*self._dispatch(img, depth))
        self._drain_event()
        return rec

    def _sense(self, img, aux):
        """Features + camera-frame 3D points of one frame (override hook).

        `aux` is the per-frame companion input: the depth map here.
        """
        feats, pts, _ = _extract_with_points(as_input(img, self.device),
                                             as_input(aux, self.device),
                                             self.intr, self.sift_cfg)
        return feats, pts

    def _sense_step(self, img, aux, kd, kv, kp, key):
        """One tracking step against a reference keyframe (override hook)."""
        return _frame_step(as_input(img, self.device), as_input(aux, self.device),
                           self.intr, kd, kv, kp, self.sift_cfg, self.match_cfg,
                           self.ransac_cfg, key)

    def _chunk_sense_step(self, fchunk, kd, kv, kp, keys):
        """N-frame tracking step against one reference (override hook).

        `fchunk` is the packed [N, 2, H, W] chunk (image and aux planes)."""
        return _chunk_step(fchunk, self.intr, kd, kv, kp, self.sift_cfg,
                           self.match_cfg, self.ransac_cfg, keys)

    def _bootstrap(self, img, depth) -> dict:
        s = self.state
        feats, pts = self._sense(img, depth)
        i = self._add_keyframe(feats.desc, feats.valid, pts,
                               np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        s.traj_ref.append(i)
        s.traj_rel_r.append(np.eye(3, dtype=np.float32))
        s.traj_rel_t.append(np.zeros(3, np.float32))
        s.traj_ok.append(True)
        rec = {"frame": 0, "kpts": int(feats.count), "matches": 0,
               "inliers": 0, "keyframe": True, "loop": False}
        self.metrics.append(rec)
        if self.on_metric:
            self.on_metric(rec)
        return rec

    def _dispatch(self, img, depth):
        """Enqueue one tracking step against the current reference keyframe;
        returns (feats, pts, packed_device, ref) without waiting."""
        ref, kd, kv, kp = self._ref_cache
        feats, pts, packed = self._sense_step(img, depth, kd, kv, kp, self._next_key())
        return feats, pts, packed, ref

    def _commit(self, feats, pts, packed, ref, index=None) -> dict:
        """Fetch one step's packed scalars and apply the SLAM decisions.

        `index` selects one frame of a chunk step's batched features, whose
        packed row the caller has fetched already; the selection is made
        only where the frame's features are read (relocalisation, a
        keyframe insert).
        """
        s = self.state
        if isinstance(packed, torch.Tensor):
            packed = packed.cpu().numpy()                # the one fetch
        inl = int(packed[0])
        n_kpts = int(packed[2])
        n_matches = int(packed[3])
        rel_r = packed[4:13].reshape(3, 3)
        rel_t = packed[13:16]
        xi = packed[16:22]
        tracked = bool(packed[1]) and inl >= self.cfg.track_min_inliers

        relocalised = False
        if not tracked:
            # relocalisation: retrieve the most similar keyframe over the
            # whole map and verify it geometrically
            if index is not None:
                feats, pts, index = _frame_of(feats, index), pts[index], None
            reloc = self._try_relocalise(feats.desc, feats.valid, pts, ref)
            if reloc is not None:
                ref, rel_r, rel_t, inl = reloc
                tracked = True
                relocalised = True
                # motion magnitudes from the RECOVERED pose
                xi = np.zeros(6, np.float32)
                xi[:3] = rel_t
                cosang = np.clip((np.trace(rel_r) - 1.0) / 2.0, -1.0, 1.0)
                xi[3] = np.arccos(cosang)
                # track the recovered keyframe from now on
                self._ref_cache = (ref, s.kf_desc[ref].clone(), s.kf_valid[ref].clone(),
                                   s.kf_pts[ref].clone())
            else:
                # still lost: copy the previous frame's pose and reference
                # (in a chunk `ref` may be stale: the copied pose is only
                # meaningful against its own reference)
                rel_r = np.asarray(s.traj_rel_r[-1])
                rel_t = np.asarray(s.traj_rel_t[-1])
                ref = int(s.traj_ref[-1])

        trans_mag = float(np.linalg.norm(xi[:3]))
        rot_mag = float(np.linalg.norm(xi[3:]))
        if (self._chunk_ref is not None and not relocalised
                and self._chunk_last_insert is not None):
            # in a chunk, xi measures motion against the reference taken at
            # dispatch, part of which a keyframe inserted earlier in the
            # chunk already covers: re-gate against that insert, or the lag
            # promotes about twice the keyframes a sequential run does
            ri, ti = self._chunk_last_insert
            rel2_r = rel_r @ ri.T
            rel2_t = rel_t - rel2_r @ ti
            trans_mag = float(np.linalg.norm(rel2_t))
            cosang = np.clip((np.trace(rel2_r) - 1.0) / 2.0, -1.0, 1.0)
            rot_mag = float(np.arccos(cosang))
        need_kf = tracked and (
            inl < self.cfg.kf_min_inliers
            or trans_mag > self.cfg.kf_max_translation
            or rot_mag > self.cfg.kf_max_rotation)

        loop_found = False
        added_kf = False
        if need_kf:
            # a deferred event must land before this insert reads poses,
            # evicts, or appends edges
            self._drain_event()
            # T_cur<-w = T_cur<-ref * T_ref<-w, before eviction shifts `ref`
            pose_r = rel_r @ s.kf_pose_r[ref]
            pose_t = rel_r @ s.kf_pose_t[ref] + rel_t
            edge_ref = ref
            if s.n_kf >= self.cfg.max_keyframes:
                v = self._evict_keyframe()
                if v is not None:
                    if edge_ref == v:
                        edge_ref = -1      # odometry ref itself evicted
                    elif edge_ref > v:
                        edge_ref -= 1
            added_kf = s.n_kf < self.cfg.max_keyframes
        if added_kf:
            if index is not None:
                feats, pts = _frame_of(feats, index), pts[index]
            desc, valid = feats.desc, feats.valid
            j = self._add_keyframe(desc, valid, pts, pose_r, pose_t)
            if edge_ref >= 0:
                # odometry edge ref -> j measured T_ref * T_j^-1
                self._add_edge(edge_ref, j, rel_r.T, -(rel_r.T @ rel_t), 1.0)
            if self._chunk_ref is not None:
                # a relocalised insert's pose is relative to the recovered
                # keyframe, not the chunk's reference: it cannot re-gate
                self._chunk_last_insert = (None if relocalised else
                                           (np.asarray(rel_r), np.asarray(rel_t)))
            if self._fused_events:
                loop_found = self._kf_event(j)
            else:
                self._local_ba()
                loop_found = self._try_loop_closure(j, desc, valid, pts)
            s.traj_ref.append(j)
            s.traj_rel_r.append(np.eye(3, dtype=np.float32))
            s.traj_rel_t.append(np.zeros(3, np.float32))
        else:
            s.traj_ref.append(ref)
            s.traj_rel_r.append(np.asarray(rel_r))
            s.traj_rel_t.append(np.asarray(rel_t))
        s.traj_ok.append(tracked)

        rec = {"frame": len(s.traj_ref) - 1, "kpts": n_kpts,
               "matches": n_matches, "inliers": inl,
               "keyframe": bool(added_kf), "loop": bool(loop_found),
               "tracked": tracked, "relocalised": relocalised}
        if self._pending_event is not None and self._pending_event[2] is None:
            # this frame's own deferred event: patch rec["loop"] at drain
            self._pending_event[2] = rec
        self.metrics.append(rec)
        if self.on_metric:
            self.on_metric(rec)
        if (added_kf and self.cfg.checkpoint_every
                and s.n_kf_total % self.cfg.checkpoint_every == 0):
            # cadence and name key on the monotonic insert count
            self.checkpoint(f"slam_ckpt_{s.n_kf_total:04d}.npz")
        return rec

    def run(self, frames, max_frames: int | None = None,
            chunk: int = 1) -> list[dict]:
        """Process an iterable of (img, depth) numpy pairs.

        Frame i+1 is uploaded by a feeder thread while frame i runs
        (`utils/pipeline.py`), and a deferred keyframe event is applied at
        the next reader of the pose/edge state.  chunk > 1 tracks `chunk`
        frames a step with one fetch of their packed rows (`_chunk_step`);
        keyframe decisions then lag by up to chunk - 1 frames, and events
        are never deferred.
        """
        if chunk > 1:
            return self._run_chunked(frames, max_frames, chunk)
        self._defer_ok = True
        for i, f in enumerate(device_frames(frames, self.device)):
            if max_frames is not None and i >= max_frames:
                break
            if self.state.n_kf == 0:
                self._bootstrap(f[0], f[1])
                continue
            self._commit(*self._dispatch(f[0], f[1]))
        self._drain_event()   # callers read poses/closure counts next
        return self.metrics

    def _run_chunked(self, frames, max_frames, chunk: int) -> list[dict]:
        self._defer_ok = False
        it = iter(frames)
        if max_frames is not None and max_frames <= 0:
            return self.metrics
        if self.state.n_kf == 0:
            first = next(it, None)
            if first is None:
                return self.metrics
            self._bootstrap(first[0], first[1])
            if max_frames is not None:
                max_frames -= 1
        done = 0
        for fchunk, n_valid in device_chunks(it, chunk, self.device):
            if max_frames is not None:
                n_valid = min(n_valid, max_frames - done)
                if n_valid <= 0:
                    break
            ref, kd, kv, kp = self._ref_cache
            # the keys of the padded frames are consumed too, as the
            # reference's are: a checkpoint's counter keeps its meaning
            feats, pts, packed = self._chunk_sense_step(fchunk, kd, kv, kp,
                                                        self._next_keys(chunk))
            rows = packed.cpu().numpy()                  # the one fetch
            # every frame of the chunk was measured against `ref`, whose
            # slot must stay resolvable while its frames commit: eviction
            # pins this holder and shifts it
            self._chunk_ref = holder = [ref]
            self._chunk_last_insert = None
            try:
                for i in range(n_valid):
                    self._commit(feats, pts, rows[i], holder[0], index=i)
            finally:
                self._chunk_ref = None
            done += n_valid
        self._drain_event()
        return self.metrics

    def _retrieve_and_verify(self, desc, valid, pts, limit: int,
                             exclude: int, min_inliers: int):
        """Best-map-candidate retrieval + rigid verification.

        Returns (cand, r, t, inliers) with X_cand = R X_query + t, or None.
        One step + one [16]-float fetch (`_retrieve_verify_step`).
        """
        if limit <= 0:
            return None
        s = self.state
        packed = _retrieve_verify_step(
            desc, valid, pts, s.kf_desc, s.kf_valid, s.kf_pts, limit, exclude,
            self.match_cfg, self.ransac_cfg, self._next_key()).cpu().numpy()
        cand, score, ok, inl = (int(packed[0]), float(packed[1]),
                                bool(packed[2]), int(packed[3]))
        if (not ok or not np.isfinite(score) or score < self.cfg.loop_min_score
                or inl < min_inliers):
            return None
        return cand, packed[4:13].reshape(3, 3), packed[13:16], inl

    def _try_relocalise(self, desc, valid, pts, ref):
        """Relocalise against the map after a tracking failure.

        Returns (keyframe, rel_r, rel_t, inliers), T_cur<-keyframe, or
        None.  Excludes `ref` (it just failed) and uses the strict
        loop_min_inliers gate: a false positive mutates the map.
        """
        res = self._retrieve_and_verify(desc, valid, pts, self.state.n_kf,
                                        ref, self.cfg.loop_min_inliers)
        if res is None:
            return None
        cand, r, t, inl = res
        return cand, r.T, -(r.T @ t), inl   # T_cur<-cand = (R, t)^-1

    def _try_loop_closure(self, j, desc, valid, pts) -> bool:
        """Retrieval + geometric verification + pose-graph update."""
        s = self.state
        limit = max(0, s.n_kf - 1 - self.cfg.loop_temporal_gap)
        res = self._retrieve_and_verify(desc, valid, pts, limit, -1,
                                        self.cfg.loop_min_inliers)
        if res is None:
            return False
        cand, r, t, _ = res
        # X_cand = R X_j + t  =>  edge cand -> j measured T_cand * T_j^-1
        self._add_edge(cand, j, r, t, 2.0)
        s.n_closures += 1
        self._optimize_graph()
        return True

    def _event_window(self):
        """(first slot, size, poses blob) of the event's BA window; size 0
        while the ring holds fewer than `local_ba_window` keyframes, or
        when BA is off.  The blob [r w*9 | t w*3] is the one upload."""
        s = self.state
        w = self.cfg.local_ba_window
        w = w if 3 <= w <= s.n_kf else 0
        lo = s.n_kf - w
        blob = torch.from_numpy(np.concatenate(
            [s.kf_pose_r[lo:s.n_kf].ravel(), s.kf_pose_t[lo:s.n_kf].ravel()]
        ).astype(np.float32)).to(self.device)
        return lo, w, blob

    def _kf_event(self, j: int) -> bool:
        """Fused keyframe event: BA + closure verification as one step, one
        upload (the window poses) and one fetch; returns whether a loop
        closure fired (False while the event is deferred)."""
        s = self.state
        lo, w, blob = self._event_window()
        limit = max(0, s.n_kf - 1 - self.cfg.loop_temporal_gap)
        if self.on_event:
            self.on_event("dispatch", j)
        dev = _kf_event_step(
            s.kf_desc, s.kf_valid, s.kf_pts, self.intr, blob, self._next_key(),
            j, s.n_kf, limit, w, self.match_cfg, self.ransac_cfg, self._ba_cfg,
            self.cfg.loop_min_score, self.cfg.loop_min_inliers)
        if self.on_event:
            self.on_event("enqueued", j)
        if self.cfg.defer_events and self._defer_ok:
            # the device runs the event while the host streams the next
            # frames; any reader of pose/edge state drains first
            self._pending_event = [j, dev, None, lo, w]
            return False
        return self._apply_event(j, dev, lo, w)

    def _apply_event(self, j: int, dev, lo: int, w: int) -> bool:
        """Fetch one event's packed result and apply it to host state; an
        accepted closure appends its edge and runs the dense graph solve."""
        s = self.state
        t0 = time.perf_counter()
        packed = dev.cpu().numpy()                        # the one fetch
        s.kf_pose_r[lo:lo + w] = packed[:w * 9].reshape(w, 3, 3)
        s.kf_pose_t[lo:lo + w] = packed[w * 9:w * 12].reshape(w, 3)
        o = w * 12
        cand, _score, accept = packed[o:o + 3]
        if accept > 0:
            self._add_edge(int(cand), j, packed[o + 6:o + 15].reshape(3, 3).copy(),
                           packed[o + 15:o + 18].copy(), 2.0)
            s.n_closures += 1
            self._optimize_graph(self._pg_dense)
        if self.on_event:
            self.on_event("applied", {
                "slot": j, "window": w, "ba_cost": (float(packed[o + 4]), float(packed[o + 5])),
                "accept": bool(accept > 0), "apply_ms": (time.perf_counter() - t0) * 1e3})
        return bool(accept > 0)

    def _drain_event(self):
        """Apply the pending deferred event, if any (idempotent)."""
        if self._pending_event is None:
            return
        j, dev, rec, lo, w = self._pending_event
        self._pending_event = None
        accept = self._apply_event(j, dev, lo, w)
        if rec is not None:
            rec["loop"] = accept

    def _local_ba(self):
        """Sliding-window BA over the last W keyframes (split form): one
        upload of the window poses, one packed pose fetch.  Runs only once
        the window is full, so the two oldest window poses are distinct
        gauge anchors."""
        lo, w, blob = self._event_window()
        if not w:
            return
        s = self.state
        win = slice(lo, s.n_kf)
        r, t, c0, c1 = window_ba(
            s.kf_desc[win], s.kf_valid[win], s.kf_pts[win],
            blob[:w * 9].reshape(w, 3, 3), blob[w * 9:].reshape(w, 3), self.intr,
            torch.ones(w, dtype=torch.float32, device=self.device),
            self.match_cfg, self._ba_cfg, anchor=self.cfg.local_ba_anchor)
        packed = torch.cat([r.reshape(-1), t.reshape(-1), torch.stack([c0, c1])]
                           ).cpu().numpy()                 # the one fetch
        s.kf_pose_r[win] = packed[:w * 9].reshape(w, 3, 3)
        s.kf_pose_t[win] = packed[w * 9:w * 12].reshape(w, 3)

    def _optimize_graph(self, cfg: PoseGraphConfig | None = None):
        """Pose-graph solve over the live ring slots (`self.pg_cfg` unless
        given): edges padded with weight-0 identities to a multiple of 64,
        two packed uploads (ints, floats), one packed fetch.

        The reference solves over the whole ring, a static shape; the
        slots above n_kf have no edge, so their dofs are not free there
        and their step is exactly 0, and leaving them out changes nothing
        but the size of the factorisation (6 n_kf, not 6 x 256).
        """
        s = self.state
        if not s.edge_i:
            return
        e = len(s.edge_i)
        cap = max(64, -(-e // 64) * 64)
        pad = cap - e
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3))
        iblob = torch.from_numpy(np.concatenate(
            [np.array(s.edge_i, np.int64), np.zeros(pad, np.int64),
             np.array(s.edge_j, np.int64), np.zeros(pad, np.int64)])).to(self.device)
        n_kf = s.n_kf
        fblob = torch.from_numpy(np.concatenate([
            s.kf_pose_r[:n_kf].ravel(), s.kf_pose_t[:n_kf].ravel(),
            np.concatenate([np.stack(s.meas_r), eye]).ravel(),
            np.concatenate([np.stack(s.meas_t), np.zeros((pad, 3), np.float32)]).ravel(),
            np.array(s.weight, np.float32), np.zeros(pad, np.float32),
        ]).astype(np.float32)).to(self.device)
        sizes = (n_kf * 9, n_kf * 3, cap * 9, cap * 3, cap)
        pr, pt, mr, mt, wt = torch.split(fblob, sizes)
        g = PoseGraph(poses_r=pr.reshape(n_kf, 3, 3), poses_t=pt.reshape(n_kf, 3),
                      edge_i=iblob[:cap], edge_j=iblob[cap:],
                      meas_r=mr.reshape(cap, 3, 3), meas_t=mt.reshape(cap, 3),
                      weight=wt)
        res = pg_optimize(g, cfg or self.pg_cfg)
        packed = torch.cat([res.poses_r.reshape(-1), res.poses_t.reshape(-1)]
                           ).cpu().numpy()                 # the one fetch
        s.kf_pose_r[:n_kf] = packed[:n_kf * 9].reshape(n_kf, 3, 3)
        s.kf_pose_t[:n_kf] = packed[n_kf * 9:].reshape(n_kf, 3)

    # ---------- outputs ----------

    def trajectory(self):
        """Per-frame world-to-camera poses (after all optimisation)."""
        self._drain_event()
        s = self.state
        rs, ts = [], []
        for ref, rel_r, rel_t in zip(s.traj_ref, s.traj_rel_r, s.traj_rel_t):
            if ref < 0:
                # baked absolute pose: the reference keyframe was evicted
                rs.append(rel_r)
                ts.append(rel_t)
                continue
            rs.append(rel_r @ s.kf_pose_r[ref])
            ts.append(rel_r @ s.kf_pose_t[ref] + rel_t)
        return np.stack(rs), np.stack(ts)

    def ate(self, gt_r, gt_t) -> float:
        est_r, est_t = self.trajectory()
        return ate_rmse(est_r, est_t, gt_r, gt_t)

    # ---------- checkpoint / resume ----------

    def checkpoint(self, path: str):
        """The whole map and trajectory as one .npz, with the keys of the
        reference's checkpoint (either package restores the other's)."""
        self._drain_event()
        np.savez_compressed(path, **slam_checkpoint_arrays(
            self.state, self._seed, self._key_ctr))

    def restore(self, path: str):
        self._drain_event()
        with np.load(path) as z:
            fields, (self._seed, self._key_ctr) = slam_state_fields(z, self.device)
        for name, value in fields.items():
            setattr(self.state, name, value)
        s = self.state
        i = s.n_kf - 1
        self._ref_cache = (i, s.kf_desc[i].clone(), s.kf_valid[i].clone(),
                           s.kf_pts[i].clone())

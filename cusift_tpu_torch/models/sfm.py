"""Small-scale incremental SfM, BASELINE configs[2] (twin of
`cusift_tpu/models/sfm.py`).

`reconstruct_rgbd`: per-frame extraction with depth backprojection,
consecutive and skip-one pair matching with rigid RANSAC, feature tracks
by union-find over the inlier matches (host graph logic), landmarks from
the earliest observation's depth, then the Schur BA of `optim/ba.py`.
`reconstruct_mono` is the depth-free form: an essential-RANSAC pair graph,
a two-view init on the best consecutive pair (|t| = 1 fixes the gauge),
PnP registration of the other frames with the previous pose as a prior,
midpoint triangulation of tracks from their widest registered pair, BA,
reprojection pruning, retriangulation and BA again.

The device steps (extraction with K1, matching with K2, the RANSAC fits,
triangulation, BA) run on `device` ("cuda" unless the caller asks for
"cpu"); the track graph lives on the host.  Each RANSAC call gets its own
generator, seeded from (seed, call) (`ops/ransac.py:step_generators`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import BAConfig, MatchConfig, RansacConfig, SiftConfig
from ..ops.essential import find_essential, triangulate_midpoint
from ..ops.match import match
from ..ops.pnp import find_pnp
from ..ops.ransac import find_rigid, step_generators
from ..optim.ba import BAProblem, BAResult, bundle_adjust
from ..utils.device import run_device
from .sift import extract
from .slam import _extract_with_points


class SfmReconstruction(NamedTuple):
    poses_r: np.ndarray    # [F, 3, 3] world-to-camera
    poses_t: np.ndarray    # [F, 3]
    points: np.ndarray     # [L, 3] world landmarks
    ba: BAResult
    n_tracks: int
    n_obs: int


class _UnionFind:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pairs(f: int) -> list[tuple[int, int]]:
    return [(i, i + 1) for i in range(f - 1)] + [(i, i + 2) for i in range(f - 2)]


def _ba(dev, poses_r, poses_t, points, intr, cam_idx, pt_idx, uvs, ws, cfg):
    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    prob = BAProblem(poses_r=t(poses_r), poses_t=t(poses_t), points=t(points), intr=intr,
                     cam_idx=t(cam_idx, np.int64), pt_idx=t(pt_idx, np.int64),
                     uv=t(uvs), w=t(ws))
    return bundle_adjust(prob, cfg)


def reconstruct_rgbd(images, depths, intr,
                     sift_cfg: SiftConfig = SiftConfig(),
                     match_cfg: MatchConfig = MatchConfig(),
                     ransac_cfg: RansacConfig = RansacConfig(),
                     ba_cfg: BAConfig = BAConfig(),
                     max_tracks: int = 4096, seed: int = 0, *,
                     device=None) -> SfmReconstruction:
    """Incremental RGB-D SfM over a short sequence (a 10-frame TUM
    snippet): extract -> pair match + rigid RANSAC for the initial poses ->
    tracks -> landmarks from the earliest observation's depth -> BA."""
    dev = run_device(device, "reconstruct_rgbd")
    f = len(images)
    intr_t = torch.as_tensor(np.asarray(intr, np.float32), device=dev)
    feats, pts3, pvalid = [], [], []
    for i in range(f):
        fe, pt, pv = _extract_with_points(
            torch.from_numpy(np.asarray(images[i], np.float32)).to(dev),
            torch.from_numpy(np.asarray(depths[i], np.float32)).to(dev), intr_t, sift_cfg)
        feats.append(fe)
        pts3.append(pt)
        pvalid.append(_host(pv))

    n = sift_cfg.total_kpts
    uf = _UnionFind(f * n)
    rel = {}
    for c, (a, b) in enumerate(_pairs(f)):
        m = match(feats[a].desc, feats[a].valid, feats[b].desc, feats[b].valid, match_cfg)
        idx = m.idx.long()
        pb = pts3[b][idx]
        ok = m.ok & torch.from_numpy(pvalid[a]).to(dev) & (pb[:, 2] > 1e-6)
        rig = find_rigid(pts3[a], pb, ok, ransac_cfg, step_generators(dev, seed, c)[0])
        if not bool(rig.ok):
            continue
        rel[(a, b)] = (_host(rig.r), _host(rig.t))
        idx_np = _host(idx)
        for ka in np.nonzero(_host(rig.inliers))[0]:
            uf.union(a * n + int(ka), b * n + int(idx_np[ka]))

    poses_r = [np.eye(3, dtype=np.float32)]
    poses_t = [np.zeros(3, np.float32)]
    for i in range(1, f):
        if (i - 1, i) in rel:
            r_rel, t_rel = rel[(i - 1, i)]
            # X_i = R X_{i-1} + t  =>  T_i<-w = (R, t) T_{i-1}<-w
            ri, ti = r_rel @ poses_r[i - 1], r_rel @ poses_t[i - 1] + t_rel
        else:                                    # tracking gap: keep the pose
            ri, ti = poses_r[i - 1], poses_t[i - 1]
        poses_r.append(ri.astype(np.float32))
        poses_t.append(ti.astype(np.float32))
    poses_r, poses_t = np.stack(poses_r), np.stack(poses_t)

    # tracks: union-find root -> observations, seen in >= 2 frames
    members: dict[int, list] = {}
    valid = [_host(fe.valid) for fe in feats]
    for fr in range(f):
        for k in np.nonzero(valid[fr] & pvalid[fr])[0]:
            members.setdefault(uf.find(fr * n + int(k)), []).append((fr, int(k)))
    tracks = [m for m in members.values() if len({fr for fr, _ in m}) >= 2][:max_tracks]

    xs = [_host(fe.x) for fe in feats]
    ys = [_host(fe.y) for fe in feats]
    pts_np = [_host(p) for p in pts3]
    cam_idx, pt_idx, uvs, points = [], [], [], []
    for li, obs in enumerate(tracks):
        obs = sorted(obs)
        fr0, k0 = obs[0]
        # landmark from the earliest observation's depth, to the world
        points.append(poses_r[fr0].T @ (pts_np[fr0][k0] - poses_t[fr0]))
        seen = set()
        for fr, k in obs:
            if fr in seen:                       # one observation per frame
                continue
            seen.add(fr)
            cam_idx.append(fr)
            pt_idx.append(li)
            uvs.append((xs[fr][k], ys[fr][k]))
    res = _ba(dev, poses_r, poses_t, np.array(points, np.float32).reshape(-1, 3), intr_t,
              cam_idx, pt_idx, np.array(uvs, np.float32).reshape(-1, 2),
              np.ones(len(cam_idx), np.float32), ba_cfg)
    return SfmReconstruction(poses_r=_host(res.poses_r), poses_t=_host(res.poses_t),
                             points=_host(res.points), ba=res, n_tracks=len(tracks),
                             n_obs=len(cam_idx))


def _triangulate_world(dev, ra, ta, rb, tb, xa_n, xb_n):
    """Triangulate normalised correspondences between two registered
    world-to-camera poses -> (world points [N, 3], za, zb, cos_parallax),
    the last the cosine of the angle between the two viewing rays."""
    r_ab = rb @ ra.T
    t_ab = tb - r_ab @ ta
    pts_a, za, zb = triangulate_midpoint(
        *(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
          for a in (r_ab, t_ab, xa_n, xb_n)))
    pts_a = _host(pts_a)
    da = np.concatenate([xa_n, np.ones_like(xa_n[:, :1])], -1)
    db = np.concatenate([xb_n, np.ones_like(xb_n[:, :1])], -1) @ r_ab
    cosp = np.abs(np.sum(da * db, -1)) / np.maximum(
        np.linalg.norm(da, axis=-1) * np.linalg.norm(db, axis=-1), 1e-12)
    return (pts_a - ta) @ ra, _host(za), _host(zb), cosp


def reconstruct_mono(images, intr,
                     sift_cfg: SiftConfig = SiftConfig(),
                     match_cfg: MatchConfig = MatchConfig(),
                     ransac_cfg: RansacConfig = RansacConfig(),
                     ba_cfg: BAConfig = BAConfig(num_fixed_poses=2),
                     max_tracks: int = 4096, seed: int = 0,
                     min_parallax_deg: float = 1.0,
                     prune_px: float = 3.0, *, device=None) -> SfmReconstruction:
    """Depth-free incremental SfM: extract -> pairwise essential-verified
    matches -> tracks -> two-view init on the consecutive pair with the
    most inliers -> PnP registration outward from it, triangulating new
    tracks as frames register -> BA -> prune (reprojection > prune_px or
    behind the camera) -> retriangulate -> BA.

    Returns poses and landmarks in the init pair's gauge (global scale is
    unobservable; evaluate with ate_rmse(..., with_scale=True)).
    """
    dev = run_device(device, "reconstruct_mono")
    f = len(images)
    intr_np = np.asarray(intr, np.float32)
    fx, fy, cx, cy = intr_np
    intr_t = torch.from_numpy(intr_np.copy()).to(dev)
    feats = [extract(torch.from_numpy(np.asarray(images[i], np.float32)).to(dev), sift_cfg)
             for i in range(f)]
    xs = [_host(fe.x) for fe in feats]
    ys = [_host(fe.y) for fe in feats]
    valid = [_host(fe.valid) for fe in feats]
    xn = [np.stack([(x - cx) / fx, (y - cy) / fy], -1).astype(np.float32)
          for x, y in zip(xs, ys)]
    xn_dev = [torch.from_numpy(a).to(dev) for a in xn]

    n = sift_cfg.total_kpts
    uf = _UnionFind(f * n)
    calls = 0
    ess = {}
    for (a, b) in _pairs(f):
        m = match(feats[a].desc, feats[a].valid, feats[b].desc, feats[b].valid, match_cfg)
        idx = m.idx.long()
        ok = m.ok & feats[a].valid & feats[b].valid[idx]
        res = find_essential(xn_dev[a], xn_dev[b][idx], ok, ransac_cfg,
                             step_generators(dev, seed, calls)[0])
        calls += 1
        if not bool(res.ok):
            continue
        inl = _host(res.inliers & ok)
        idx_np = _host(idx)
        ess[(a, b)] = (_host(res.r), _host(res.t), int(res.num_inliers))
        for ka in np.nonzero(inl)[0]:
            uf.union(a * n + int(ka), b * n + int(idx_np[ka]))

    # ---- track table: root -> [(frame, slot)], >= 2 distinct frames ----
    members: dict[int, list] = {}
    for fr in range(f):
        for k in np.nonzero(valid[fr])[0]:
            members.setdefault(uf.find(fr * n + int(k)), []).append((fr, int(k)))
    tracks = []
    for m_ in members.values():
        frames_seen = {}
        for fr, k in sorted(m_):
            frames_seen.setdefault(fr, k)        # one observation per frame
        if len(frames_seen) >= 2:
            tracks.append(sorted(frames_seen.items()))
    tracks = tracks[:max_tracks]
    track_of = {(fr, k): li for li, obs in enumerate(tracks) for fr, k in obs}
    l = len(tracks)

    # ---- two-view init on the best consecutive pair (|t| = 1 gauge) ----
    init_pair = max(((a, b) for (a, b) in ess if b == a + 1),
                    key=lambda p: ess[p][2], default=None)
    if init_pair is None:
        raise RuntimeError("mono SfM: no consecutive pair verified")
    a0, b0 = init_pair
    poses_r = {a0: np.eye(3, dtype=np.float32), b0: ess[init_pair][0].astype(np.float32)}
    poses_t = {a0: np.zeros(3, np.float32), b0: ess[init_pair][1].astype(np.float32)}

    points = np.zeros((l, 3), np.float32)
    have_point = np.zeros(l, bool)
    min_cosp = np.cos(np.deg2rad(min_parallax_deg))

    def triangulate_tracks(which):
        """Triangulate tracks (ids) from their widest registered pair."""
        by_pair: dict[tuple, list] = {}
        for li in which:
            reg = [(fr, k) for fr, k in tracks[li] if fr in poses_r]
            if len(reg) < 2:
                continue
            (fa, ka), (fb, kb) = reg[0], reg[-1]
            by_pair.setdefault((fa, fb), []).append((li, ka, kb))
        for (fa, fb), items in by_pair.items():
            lis = np.array([i[0] for i in items])
            pw, za, zb, cosp = _triangulate_world(
                dev, poses_r[fa], poses_t[fa], poses_r[fb], poses_t[fb],
                xn[fa][[i[1] for i in items]], xn[fb][[i[2] for i in items]])
            good = (za > 1e-6) & (zb > 1e-6) & (cosp < min_cosp)
            points[lis[good]] = pw[good]
            have_point[lis[good]] = True

    triangulate_tracks(range(l))

    # ---- incremental registration, outward from the init pair ----
    for fr in [*range(b0 + 1, f)] + [*range(a0 - 1, -1, -1)]:
        obs_mask = np.zeros(n, bool)
        pts_w = np.zeros((n, 3), np.float32)
        for k in np.nonzero(valid[fr])[0]:
            li = track_of.get((fr, int(k)))
            if li is not None and have_point[li]:
                obs_mask[k] = True
                pts_w[k] = points[li]
        # the previous registered neighbour's pose: the LO-RANSAC prior
        prev = fr - 1 if fr > b0 else fr + 1
        init = ((torch.from_numpy(poses_r[prev]).to(dev), torch.from_numpy(poses_t[prev]).to(dev))
                if prev in poses_r else None)
        res = find_pnp(torch.from_numpy(pts_w).to(dev), xn_dev[fr],
                       torch.from_numpy(obs_mask).to(dev), ransac_cfg,
                       step_generators(dev, seed, calls)[0], init=init)
        calls += 1
        if not bool(res.ok):
            # registration failure: carry the neighbour's pose
            res_r = poses_r.get(prev, np.eye(3, dtype=np.float32))
            res_t = poses_t.get(prev, np.zeros(3, np.float32))
        else:
            res_r, res_t = _host(res.r), _host(res.t)
        poses_r[fr] = res_r.astype(np.float32)
        poses_t[fr] = res_t.astype(np.float32)
        triangulate_tracks([li for li in range(l) if not have_point[li]])

    pr = np.stack([poses_r[i] for i in range(f)])
    pt = np.stack([poses_t[i] for i in range(f)])

    # ---- observation table (one shape through both BA rounds) ----
    obs = [(fr, li, xs[fr][k], ys[fr][k]) for li, tr in enumerate(tracks) if have_point[li]
           for fr, k in tr]
    cam_idx = np.array([o[0] for o in obs], np.int64)
    pt_idx = np.array([o[1] for o in obs], np.int64)
    uvs = np.array([o[2:] for o in obs], np.float32).reshape(-1, 2)
    ws = np.ones(len(obs), np.float32)

    # gauge: the init pair's cameras are fixed when they are poses 0 and 1;
    # otherwise pose 0 alone
    nfix = 2 if (a0, b0) == (0, 1) else 1
    ba_cfg = dataclasses.replace(ba_cfg, num_fixed_poses=max(nfix, 1))

    def run_ba(pr, pt, points, ws):
        res = _ba(dev, pr, pt, points, intr_t, cam_idx, pt_idx, uvs, ws, ba_cfg)
        return _host(res.poses_r), _host(res.poses_t), _host(res.points), res

    pr, pt, points_ba, res = run_ba(pr, pt, points, ws)
    points[have_point] = points_ba[have_point]

    # ---- reprojection pruning + retriangulation + the final BA round ----
    pc = np.einsum("oij,oj->oi", pr[cam_idx], points[pt_idx]) + pt[cam_idx]
    z = np.maximum(pc[:, 2], 1e-9)
    proj = np.stack([pc[:, 0] / z * fx + cx, pc[:, 1] / z * fy + cy], -1)
    err = np.linalg.norm(proj - uvs, axis=-1)
    ws = ws * ((err < prune_px) & (pc[:, 2] > 1e-3)).astype(np.float32)
    # drop landmarks with < 2 surviving observations
    live_count = np.bincount(pt_idx, weights=ws, minlength=l)
    ws = ws * (live_count[pt_idx] >= 2)
    for i in range(f):
        poses_r[i], poses_t[i] = pr[i], pt[i]
    live = [li for li in range(l) if live_count[li] >= 2]
    have_point[:] = False
    have_point[live] = True
    triangulate_tracks(live)
    pr2, pt2, points_ba, res = run_ba(pr, pt, points, ws)
    points[have_point] = points_ba[have_point]
    return SfmReconstruction(poses_r=pr2, poses_t=pt2, points=points, ba=res,
                             n_tracks=int(have_point.sum()), n_obs=int((ws > 0).sum()))

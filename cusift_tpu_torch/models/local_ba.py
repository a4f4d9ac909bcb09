"""Sliding-window local bundle adjustment for the SLAM backend (twin of
`cusift_tpu/models/local_ba.py`).

Every keyframe insert bundle-adjusts the landmarks seen by the last W
keyframes: cross-keyframe data association (descriptor matching through
kernel K2), landmark initialisation from the RGB-D backprojections, and
the LM/Schur/PCG solve of `optim/ba.py`, all over fixed [W, N, ...]
slices of the keyframe ring.
"""

from __future__ import annotations

import torch

from ..config import BAConfig, MatchConfig
from ..ops.geometry import project
from ..ops.match import match
from ..optim.ba import BAProblem, lm_loop


def _world_points(kf_pts, poses_r, poses_t):
    """[W, N, 3] camera-frame points -> world, R^T (X_c - t) per keyframe."""
    return (kf_pts - poses_t[:, None, :]) @ poses_r


def _to_camera(pts_w, poses_r, poses_t):
    """[W, N, 3] world points -> each keyframe's camera frame."""
    return pts_w @ poses_r.transpose(-1, -2) + poses_t[:, None, :]


def build_window_problem_union(kf_desc, kf_valid, kf_pts, poses_r, poses_t,
                               intr, win_mask,
                               match_cfg: MatchConfig = MatchConfig(),
                               gate_px: float = 25.0) -> BAProblem:
    """All-window landmark union (standard local BA anchoring).

    Every keyframe's backprojections are landmark candidates, deduplicated
    through the pairwise match graph: slot (k, s) joins the landmark of
    the EARLIEST window keyframe it matches (one-step owner indirection,
    fully transitive because owners are final in ascending-k order),
    otherwise it founds its own.  Landmarks: all W*N slots (dead ones
    weight 0); observations: the [W, N] grid, each slot observing its
    owner.  The landmark index is arbitrary, so the problem is not a grid
    (`BAProblem.grid` False: its segment sums take `kernels/segment.py`).
    """
    w, n = kf_valid.shape
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    valid = kf_valid & (kf_pts[..., 2] > 1e-6) & (win_mask[:, None] > 0)
    pw_flat = _world_points(kf_pts, poses_r, poses_t).reshape(w * n, 3)

    dev = kf_pts.device
    owner = (torch.arange(w, device=dev)[:, None] * n
             + torch.arange(n, device=dev)[None, :])               # [W, N] self-own
    owner_rows = [owner[0]]
    for k in range(1, w):
        own_k = owner[k]
        assigned = torch.zeros(n, dtype=torch.bool, device=dev)
        for j in range(k):
            m = match(kf_desc[k], valid[k], kf_desc[j], valid[j], match_cfg)
            mi = m.idx.long()
            okj = m.ok & valid[k] & valid[j][mi] & ~assigned
            # one-step indirection: row j's owners are already final
            own_k = torch.where(okj, owner_rows[j][mi], own_k)
            assigned = assigned | okj
        owner_rows.append(own_k)
    owner = torch.stack(owner_rows)                                # [W, N]

    uv = project(kf_pts, fx, fy, cx, cy)
    own_c = _to_camera(pw_flat[owner], poses_r, poses_t)           # [W, N, 3]
    pred = project(own_c, fx, fy, cx, cy)
    owner_valid = valid.reshape(-1)[owner]
    # near-plane gate: a landmark at/behind the observing camera (z ~ 0)
    # can project near the principal point and pass the pixel gate, but
    # its Jacobian entries ~fx/z overflow f32 in J^T J
    ok = (valid & owner_valid & (own_c[..., 2] > 1e-2)
          & (((uv - pred) ** 2).sum(-1) < gate_px ** 2))

    cam_idx = torch.arange(w, device=dev).repeat_interleave(n)
    return BAProblem(
        poses_r=poses_r, poses_t=poses_t, points=pw_flat, intr=intr,
        cam_idx=cam_idx, pt_idx=owner.reshape(-1), uv=uv.reshape(-1, 2),
        w=ok.reshape(-1).to(torch.float32))


def build_window_problem(kf_desc, kf_valid, kf_pts, poses_r, poses_t,
                         intr, win_mask,
                         match_cfg: MatchConfig = MatchConfig(),
                         gate_px: float = 25.0) -> BAProblem:
    """Data association + landmark init for a keyframe window -> BAProblem.

    Landmarks anchor to the NEWEST keyframe: its valid backprojections in
    world coordinates, matched against every window keyframe (itself
    included).  The observations are the [W, N] grid (`BAProblem.grid`).
    """
    w, n = kf_valid.shape
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    anchor = w - 1
    pts_j = kf_pts[anchor]                                        # [N, 3]
    valid_j = kf_valid[anchor] & (pts_j[:, 2] > 1e-6)
    points_w = (pts_j - poses_t[anchor]) @ poses_r[anchor]        # R^T (X_c - t)

    uvs, oks = [], []
    for k in range(w):
        m = match(kf_desc[anchor], valid_j, kf_desc[k], kf_valid[k], match_cfg)
        pk = kf_pts[k][m.idx.long()]                              # [N, 3]
        uv = project(pk, fx, fy, cx, cy)
        ok = m.ok & valid_j & (pk[:, 2] > 1e-6)
        # projection gate: a descriptor match far from the landmark's
        # predicted projection under the current pose is a misassociation
        pc = points_w @ poses_r[k].T + poses_t[k]
        pred = project(pc, fx, fy, cx, cy)
        ok = ok & (pc[:, 2] > 1e-2) & (((uv - pred) ** 2).sum(-1) < gate_px ** 2)
        uvs.append(uv)
        oks.append(ok)
    ok = torch.stack(oks) & (win_mask[:, None] > 0)

    dev = kf_pts.device
    cam_idx = torch.arange(w, device=dev).repeat_interleave(n)
    pt_idx = torch.arange(n, device=dev).repeat(w)
    return BAProblem(
        poses_r=poses_r, poses_t=poses_t, points=points_w, intr=intr,
        cam_idx=cam_idx, pt_idx=pt_idx, uv=torch.stack(uvs).reshape(-1, 2),
        w=ok.reshape(-1).to(torch.float32), grid=True)


def window_ba(kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr,
              win_mask,
              match_cfg: MatchConfig = MatchConfig(),
              ba_cfg: BAConfig = BAConfig(max_iters=5, cg_iters=15,
                                          num_fixed_poses=2,
                                          huber_delta=4.0),
              gate_px: float = 25.0, anchor: str = "newest"):
    """Local BA over a keyframe window.

    kf_desc [W, N, 128], kf_valid [W, N], kf_pts [W, N, 3] (camera-frame
    backprojections), poses_r/t [W] world-to-camera, win_mask [W] (0 pads
    a window larger than the map: padded cameras contribute no
    observations and keep their input pose).  Window order is
    oldest-first; the two oldest keyframes are the gauge anchors.
    Returns (poses_r [W, 3, 3], poses_t [W, 3], initial_cost, final_cost).
    `anchor` picks the landmark scheme: "newest" (default) or "union".
    """
    build = build_window_problem_union if anchor == "union" else build_window_problem
    prob = build(kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr, win_mask,
                 match_cfg, gate_px)
    res = lm_loop(prob, ba_cfg)
    keep = win_mask[:, None, None] > 0
    r_out = torch.where(keep, res.poses_r, poses_r)
    t_out = torch.where(keep[..., 0], res.poses_t, poses_t)
    return r_out, t_out, res.initial_cost, res.cost

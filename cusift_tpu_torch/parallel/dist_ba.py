"""Distributed bundle adjustment by a sharded Schur reduction (twin of
`cusift_tpu/parallel/dist_ba.py`).

Landmarks and their observations split over the mesh's "map" axis, each
landmark's observations on the rank that holds it, so the landmark blocks
V and the per-landmark reduction t_p stay on that rank.  The poses are
replicated; the reduced camera system is all-reduced and solved the same
way on every rank; landmark back-substitution is local.  The solver is
`optim/ba.py:lm_loop` with the "map" group: the single-device and the
distributed paths share every line of the math.

Each function is collective: every rank of the mesh calls it with the same
arguments (rank s solves shard s).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BAConfig, MatchConfig
from ..optim.ba import BAProblem, BAResult, lm_loop
from ..utils.precision import f32_matmuls
from .mesh import MAP, all_gather_rows, axis_size, broadcast


def partition_by_landmark(problem: dict, n_shards: int) -> dict:
    """Host-side partitioning of a BA problem into landmark-colocated shards.

    Landmarks are dealt round-robin by index; observations follow their
    landmark.  Shards are padded to equal sizes (weight 0 padding).
    Returns arrays with a leading [n_shards] axis and shard-local pt_idx.
    """
    pt_idx = np.asarray(problem["pt_idx"])
    n_pts = problem["points"].shape[0]
    shard_of_pt = np.arange(n_pts) % n_shards
    local_pt = np.arange(n_pts) // n_shards          # shard-local landmark id
    l_shard = int(np.ceil(n_pts / n_shards))
    o_shard = 0
    obs_by_shard = []
    for s in range(n_shards):
        sel = np.nonzero(shard_of_pt[pt_idx] == s)[0]
        obs_by_shard.append(sel)
        o_shard = max(o_shard, len(sel))

    def pad_obs(arr, sel, fill=0):
        out = np.full((o_shard,) + arr.shape[1:], fill, arr.dtype)
        out[: len(sel)] = arr[sel]
        return out

    points = np.zeros((n_shards, l_shard, 3), np.float32)
    for p in range(n_pts):
        points[shard_of_pt[p], local_pt[p]] = problem["points"][p]

    return dict(
        poses_r=problem["poses_r"], poses_t=problem["poses_t"],
        intr=problem["intr"], points=points,
        cam_idx=np.stack([pad_obs(problem["cam_idx"], s) for s in obs_by_shard]),
        pt_idx=np.stack([pad_obs(local_pt[pt_idx].astype(np.int32), s)
                         for s in obs_by_shard]),
        uv=np.stack([pad_obs(problem["uv"], s) for s in obs_by_shard]),
        w=np.stack([pad_obs(problem["w"], s) for s in obs_by_shard]),
        # bookkeeping to scatter results back: global id per local slot
        global_pt=np.stack([
            np.concatenate([np.nonzero(shard_of_pt == s)[0],
                            np.full(l_shard - (shard_of_pt == s).sum(), -1)])
            for s in range(n_shards)]).astype(np.int32),
    )


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


@f32_matmuls
def distributed_bundle_adjust(parts: dict, mesh, cfg: BAConfig = BAConfig(),
                              device=None) -> BAResult:
    """LM bundle adjustment over landmark shards on the "map" axis.

    `parts` comes from `partition_by_landmark` with one shard per "map"
    rank (leading [n_shards] axis on observation and landmark arrays;
    poses replicated); this rank solves its shard on `device` (default:
    the GPU for an NCCL mesh, the CPU for a gloo one).  Returns a BAResult
    whose points keep the [n_shards, L_shard, 3] layout (`gather_points`
    reassembles the global array).
    """
    if device is None:
        device = mesh.device_type
    n = axis_size(mesh, MAP)
    if parts["points"].shape[0] != n:
        raise ValueError(f"{parts['points'].shape[0]} shards for a {n}-rank map axis")
    s = mesh.get_local_rank(MAP)
    p = BAProblem(poses_r=_tensor(parts["poses_r"], device),
                  poses_t=_tensor(parts["poses_t"], device),
                  points=_tensor(parts["points"][s], device),
                  intr=_tensor(parts["intr"], device),
                  cam_idx=_tensor(parts["cam_idx"][s], device),
                  pt_idx=_tensor(parts["pt_idx"][s], device),
                  uv=_tensor(parts["uv"][s], device), w=_tensor(parts["w"][s], device))
    res = lm_loop(p, cfg, group=mesh.get_group(MAP))
    return res._replace(points=all_gather_rows(res.points[None], mesh, MAP))


@f32_matmuls
def window_ba_dist(kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr,
                   win_mask, mesh, match_cfg=None, ba_cfg: BAConfig = None,
                   gate_px: float = 25.0):
    """Distributed sliding-window BA: `models/local_ba.py:window_ba` with
    the Schur solve split over the mesh's "map" axis.

    The window problem's observations are the [W, N] grid, landmark n
    owning column n, so landmark-colocated sharding is a static reshape:
    rank s owns the landmark block [s L, (s+1) L) and its observations are
    the matching [W, L] sub-grid (a grid again, `BAProblem.grid`).
    Association runs replicated; the reduced camera system rides one
    all-reduce per CG round.  The window's inputs are first broadcast from
    the group's first rank, so ranks that drifted apart still solve one
    problem.  Same signature as `window_ba` plus `mesh`; returns the same
    (poses_r, poses_t, initial_cost, final_cost).
    """
    from ..models.local_ba import build_window_problem

    if match_cfg is None:
        match_cfg = MatchConfig()
    if ba_cfg is None:
        ba_cfg = BAConfig(max_iters=5, cg_iters=15, num_fixed_poses=2, huber_delta=4.0)
    group = mesh.get_group(MAP)
    n_shards = axis_size(mesh, MAP)
    w, n = kf_valid.shape
    if n % n_shards:
        raise ValueError(f"{n} landmark slots do not split over {n_shards} shards")
    kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr, win_mask = (
        broadcast(x, group)
        for x in (kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr, win_mask))
    prob = build_window_problem(kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr,
                                win_mask, match_cfg, gate_px)
    l_shard = n // n_shards
    s = mesh.get_local_rank(MAP)
    cols = slice(s * l_shard, (s + 1) * l_shard)
    dev = kf_pts.device
    local = BAProblem(
        poses_r=prob.poses_r, poses_t=prob.poses_t,
        points=prob.points[cols], intr=prob.intr,
        cam_idx=torch.arange(w, device=dev).repeat_interleave(l_shard),
        pt_idx=torch.arange(l_shard, device=dev).repeat(w),
        uv=prob.uv.reshape(w, n, 2)[:, cols].reshape(-1, 2),
        w=prob.w.reshape(w, n)[:, cols].reshape(-1), grid=True)
    res = lm_loop(local, ba_cfg, group=group)
    keep = win_mask[:, None, None] > 0
    r_out = torch.where(keep, res.poses_r, poses_r)
    t_out = torch.where(keep[..., 0], res.poses_t, poses_t)
    return r_out, t_out, res.initial_cost, res.cost


def gather_points(parts: dict, sharded_points) -> np.ndarray:
    """Reassemble [L, 3] global landmarks from sharded [S, L_s, 3] output."""
    gp = np.asarray(parts["global_pt"])
    pts = np.asarray(sharded_points.cpu() if isinstance(sharded_points, torch.Tensor)
                     else sharded_points)
    n_pts = int(gp.max()) + 1
    out = np.zeros((n_pts, 3), np.float32)
    for s in range(gp.shape[0]):
        valid = gp[s] >= 0
        out[gp[s][valid]] = pts[s][valid]
    return out

"""Trajectory-partitioned distributed pose-graph optimisation (twin of
`cusift_tpu/parallel/dist_pg.py`).

Long sequences partition into contiguous keyframe chunks: the poses stay
replicated ([N, 6] dof), the edges split by their source keyframe so each
rank owns its chunk's constraints, and the only cross-rank quantities are
the [N, 6] J^T r and J^T J x vectors, one all-reduce each
(`optim/posegraph.py:lm_loop` with the "map" group).  Every rank then runs
the same CG, so the distributed solve is the single-device solve.
"""

from __future__ import annotations

import numpy as np

from ..config import PoseGraphConfig
from ..optim.posegraph import PoseGraph, PoseGraphResult, lm_loop
from .mesh import MAP, block


def partition_edges(edge_i: np.ndarray, edge_j: np.ndarray,
                    meas_r: np.ndarray, meas_t: np.ndarray,
                    weight: np.ndarray, n_shards: int) -> dict:
    """Sort edges by source keyframe and pad to a shard multiple.

    Sorting by `edge_i` makes each shard's slice a contiguous trajectory
    chunk's constraints (odometry edges are naturally ordered; loop
    closures land on the chunk owning their source keyframe).  Padded
    edges carry weight 0, which zeroes their residuals exactly.
    """
    order = np.argsort(edge_i, kind="stable")
    e = len(order)
    pad = (-e) % n_shards

    def take(a):
        a = np.asarray(a)
        return np.concatenate([a[order], np.zeros((pad,) + a.shape[1:], a.dtype)])

    return dict(edge_i=take(edge_i.astype(np.int32)),
                edge_j=take(edge_j.astype(np.int32)),
                meas_r=take(meas_r.astype(np.float32)),
                meas_t=take(meas_t.astype(np.float32)),
                weight=take(weight.astype(np.float32)))


def distributed_pg_optimize(g: PoseGraph, mesh,
                            cfg: PoseGraphConfig = PoseGraphConfig()) -> PoseGraphResult:
    """Pose-graph optimisation with the edges split over the "map" axis.

    g's edge arrays must already be padded to a multiple of the axis size
    (`partition_edges`); rank s takes the s-th contiguous block.  Poses are
    replicated in and out.  Collective over the mesh.
    """
    local = g._replace(edge_i=block(g.edge_i, mesh, MAP), edge_j=block(g.edge_j, mesh, MAP),
                       meas_r=block(g.meas_r, mesh, MAP), meas_t=block(g.meas_t, mesh, MAP),
                       weight=block(g.weight, mesh, MAP))
    return lm_loop(local, cfg, group=mesh.get_group(MAP))

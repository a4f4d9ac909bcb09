"""Sharded feature pipelines (twin of `cusift_tpu/parallel/sharded.py`).

Frame-parallel extraction: a batch of frames splits over the mesh's
"frames" axis, each rank extracts its block with `extract_batch` (kernel
K1 in every octave) and the features come back whole on every rank.
Retrieval against a keyframe database splits the database's descriptor
axis over "map": each rank scores its slice and a max all-reduce combines
the partial maxima.  Pair matching splits a batch of descriptor-set pairs
over "frames" (one batched K2 launch a rank, the reference's
`jax.vmap(match)`).

Every rank passes the whole inputs (the reference's global arrays) and
gets the whole result; the call is collective over the mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import MatchConfig, SiftConfig
from ..models.sift import SiftFeatures, extract_batch
from ..ops.match import Matches, match
from ..utils.precision import f32_matmuls
from .mesh import FRAMES, MAP, all_gather_rows, block


def extract_frames(imgs: torch.Tensor, mesh, cfg: SiftConfig = SiftConfig()) -> SiftFeatures:
    """Features of [B, H, W] frames split over "frames" (B divisible by
    the axis size).  Every field keeps the leading B axis."""
    local = extract_batch(block(imgs, mesh, FRAMES), cfg)
    return SiftFeatures(*(all_gather_rows(a, mesh, FRAMES) for a in local))


@f32_matmuls
def retrieval_scores(query_desc: torch.Tensor, query_valid: torch.Tensor,
                     db_desc: torch.Tensor, db_valid: torch.Tensor, mesh) -> torch.Tensor:
    """Loop-closure retrieval: match-count score of a query against a
    keyframe database whose descriptor axis splits over "map".

    query_desc [N, 128]; db_desc [KF, M, 128] -> scores [KF]: the summed
    best-correlation mass per keyframe.  Each rank takes its best over its
    M slice, zeroes non-finite bests and invalid query rows, and the
    partial maxima combine by a max all-reduce, as the reference's pmax.
    """
    db = db_desc.transpose(0, 1)
    dbv = db_valid.transpose(0, 1)
    db = block(db, mesh, MAP).transpose(0, 1)                    # [KF, M_s, 128]
    dbv = block(dbv, mesh, MAP).transpose(0, 1)
    sim = torch.einsum("nd,kmd->knm", query_desc.to(torch.float32), db.to(torch.float32))
    sim = torch.where(dbv[:, None, :], sim, torch.full_like(sim, -torch.inf))
    best = sim.max(-1).values                                      # [KF, N]
    best = torch.where(query_valid[None, :] & torch.isfinite(best), best,
                       torch.zeros_like(best))
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=mesh.get_group(MAP))
    return best.sum(-1) / query_valid.to(torch.float32).sum().clamp(min=1.0)


def match_pairs_sharded(desc_a: torch.Tensor, valid_a: torch.Tensor,
                        desc_b: torch.Tensor, valid_b: torch.Tensor,
                        mesh, cfg: MatchConfig = MatchConfig()) -> Matches:
    """A batch of descriptor-set pairs matched in parallel over "frames".

    desc_a, desc_b: [B, N, 128] (B divisible by the axis size); returns
    Matches with a leading B axis.
    """
    da, va, db, vb = (block(x, mesh, FRAMES) for x in (desc_a, valid_a, desc_b, valid_b))
    local = match(da, va, db, vb, cfg)             # one batched match of the rank's frames
    return Matches(*(all_gather_rows(x, mesh, FRAMES) for x in local))

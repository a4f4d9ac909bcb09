"""Deterministic segment sums (CUDA kernel `csrc/segment.cu`).

No TPU kernel is replaced: the reference sums by segment with XLA's
scatter-add (`jax.ops.segment_sum`, `.at[].add`), whose order is fixed for
a given compile.  torch's `index_add_` on CUDA adds with float atomics, so
its bits change from run to run; on the card every scatter-add of the
port's solvers (`optim/ba.py`, `optim/posegraph.py`, `optim/sim3graph.py`)
and of the landmark map (`models/monomap.py`) goes through `segment_sum`.

`plan(idx, n)` is made once per problem (the indices do not change inside
an LM solve, whose CG calls the sum every round): on the card it sorts the
rows stably by segment and finds each segment's offsets, on the device
and without a host read.  The kernel adds each segment's rows in
ascending row order from 0, the order of the CPU's `index_add_`, so on the
same inputs the card's bits equal the CPU's.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
`segment_sum_plain`, the `index_add_` the port used before, so every CPU
result keeps its bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

launches = 0   # calls of `segment_sum` that launched the kernel


class Plan(NamedTuple):
    """Rows grouped by segment; `order` and `offsets` only on the card."""

    idx: torch.Tensor                 # [R] int64 segment of each row
    n: int                            # number of segments
    order: torch.Tensor | None        # [R] rows sorted stably by segment
    offsets: torch.Tensor | None      # [n + 1] int64: segment s owns
                                      #   order[offsets[s]:offsets[s + 1]]


def walk(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets): the rows sorted stably by segment, and where each
    segment's rows start in `order` (the kernel's walk).  Rows whose index
    lies outside [0, n) fall outside every segment."""
    srt, order = torch.sort(idx.long(), stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=idx.device)
    return order, torch.searchsorted(srt, bounds)


def plan(idx: torch.Tensor, n: int) -> Plan:
    """The plan of a sum of rows by `idx` into `n` segments; the walk is
    made on the card only.  Rows whose index lies outside [0, n) are left
    out on the card (the reference's mode="drop"); the CPU's `index_add_`
    refuses them."""
    idx = idx.long()
    if idx.device.type != "cuda":
        return Plan(idx, n, None, None)
    return Plan(idx, n, *walk(idx, n))


def segment_sum_plain(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """Plain torch version: `index_add_` of x's rows into p.n zero rows."""
    return x.new_zeros((p.n,) + tuple(x.shape[1:])).index_add_(0, p.idx, x)


def segment_sum(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """out [n, ...] with out[s] = sum of x[r] over rows r of segment s, in
    ascending r.  x [R, ...] float32 or float64."""
    global launches
    if x.device.type == "cpu":
        return segment_sum_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum: no kernel for {x.device}")
    if p.order is None or p.order.device != x.device:
        raise ValueError(f"segment_sum: the plan was made on {p.idx.device}, "
                         f"x lies on {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"segment_sum: no kernel for {x.dtype}")
    if x.shape[0] != p.order.shape[0]:
        raise ValueError(f"segment_sum: {x.shape[0]} rows against a plan of "
                         f"{p.order.shape[0]}")
    rows = x.shape[0]
    d = 1
    for s in x.shape[1:]:
        d *= s
    out = torch.empty((p.n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if p.n == 0 or d == 0:
        return out
    if rows == 0:
        return out.zero_()
    x = x.contiguous()
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cusift_segment_sum(x.data_ptr(), p.order.data_ptr(), p.offsets.data_ptr(),
                                     out.data_ptr(), p.n, d, int(x.dtype == torch.float64),
                                     stream)
    _build.check(err, "cusift_segment_sum")
    launches += 1
    return out

"""Deterministic segment sums (CUDA kernel `csrc/segment.cu`).

No TPU kernel is replaced: the reference sums by segment with XLA's
scatter-add (`jax.ops.segment_sum`, `.at[].add`), whose order is fixed for
a given compile.  torch's `index_add_` on CUDA adds with float atomics, so
its bits change from run to run; on the card every scatter-add of the
port's solvers (`optim/ba.py`, `optim/posegraph.py`, `optim/sim3graph.py`)
and of the landmark map (`models/monomap.py`) goes through `segment_sum`.

`plan(idx, n)` is made once per problem (the indices do not change inside
an LM solve, whose CG calls the sum every round), on the device and
without a host read: on the card it sorts the rows stably by segment,
finds each segment's offsets (`walk`), and cuts the sorted rows into
blocks (`partition`): each CUDA block owns the segments whose first sorted
row lies in its tile of TILE rows.  The kernel gathers a block's rows into
shared memory and adds each segment's rows in ascending row order from 0,
the order of the CPU's `index_add_`, so on the same inputs the card's bits
equal the CPU's (`csrc/segment.cu` for the design).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
`segment_sum_plain`, the `index_add_` the port used before, so every CPU
result keeps its bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import trace
from . import _build


TILE = 128          # sorted rows in which a block's segments start
THREADS = 256       # threads a block
WIDE_THREADS = 512  # threads a block of column tiles of WIDE_COLS or more
WIDE_COLS = 16
MAX_COLS = 48       # widest column tile of a block
MAX_CHUNK = 512     # most rows a block stages at once
SMEM_BUDGET = 96 * 1024   # shared bytes a block may take


class Plan(NamedTuple):
    """Rows grouped by segment; everything after `n` only on the card."""

    idx: torch.Tensor                 # [R] int64 segment of each row
    n: int                            # number of segments
    order: torch.Tensor | None        # [R] rows sorted stably by segment
    offsets: torch.Tensor | None      # [n + 1] int64: segment s owns
                                      #   order[offsets[s]:offsets[s + 1]]
    seg: torch.Tensor | None = None   # [R] int32 segment of each sorted row
    ends: torch.Tensor | None = None  # [R] int32 end of that segment in `order`
    blocks: torch.Tensor | None = None  # [nb + 1, 2] int32 (first segment,
                                        #   its first sorted row) of each block
    tile: int = 0                     # sorted rows of a block's tile


def walk(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets): the rows sorted stably by segment, and where each
    segment's rows start in `order` (the kernel's walk).  Rows whose index
    lies outside [0, n) fall outside every segment."""
    srt, order = torch.sort(idx.long(), stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=idx.device)
    return order, torch.searchsorted(srt, bounds)


def partition(idx: torch.Tensor, n: int, order: torch.Tensor, offsets: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(seg, ends, blocks) of the walk: each sorted row's segment and the
    end of its segment in `order`; and for each of the ceil(R / TILE)
    blocks, the first segment whose first sorted row lies at or after the
    block's tile start, with that row, and past the last block the first
    trailing segment (no row at or after its start), with that row.
    Block b owns the segments blocks[b, 0] .. blocks[b + 1, 0] - 1, which
    hold the sorted rows blocks[b, 1] .. blocks[b + 1, 1] - 1; every
    segment before the trailing ones and every row inside [0, n) belongs
    to one block, and the trailing segments (empty) to none.  On the
    device, no host read."""
    rows = order.shape[0]
    if rows >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"segment plan: {rows} rows into {n} segments exceed int32")
    srt = idx.long()[order]
    seg = srt.clamp(-1, n).to(torch.int32)
    ends = offsets[(srt + 1).clamp(0, n)].to(torch.int32)
    nb = -(-rows // TILE)
    starts = torch.arange(nb + 1, dtype=torch.int64, device=idx.device) * TILE
    tail = torch.searchsorted(offsets, offsets[n:])
    first = torch.minimum(torch.searchsorted(offsets[:n].contiguous(), starts), tail)
    first[nb:] = tail
    return seg, ends, torch.stack((first, offsets[first]), 1).to(torch.int32)


def plan(idx: torch.Tensor, n: int) -> Plan:
    """The plan of a sum of rows by `idx` into `n` segments; the walk and
    the partition are made on the card only.  Rows whose index lies
    outside [0, n) are left out on the card (the reference's mode="drop");
    the CPU's `index_add_` refuses them."""
    idx = idx.long()
    if idx.device.type != "cuda":
        return Plan(idx, n, None, None)
    order, offsets = walk(idx, n)
    return Plan(idx, n, order, offsets, *partition(idx, n, order, offsets), tile=TILE)


def launch_shape(d: int, itemsize: int) -> dict:
    """The kernel's launch for rows of d elements of `itemsize` bytes:
    column tiles of at most MAX_COLS (`d_tile`, gridDim.y ceil(d /
    d_tile)), `chunk` rows a stage (a multiple of 8: two column-major
    slabs, three index stages and a piece list within SMEM_BUDGET), the
    threads (more for wide tiles, whose chunks take more copies), and the
    shared bytes of that layout (csrc/segment.cu)."""
    d_tile = -(-d // -(-d // MAX_COLS))
    # a column holds chunk rows and 16 bytes of padding; each row of a
    # stage also takes 8 + 4 + 4 index bytes in three stages and 4 in the
    # piece list
    per_row = 2 * d_tile * itemsize + 3 * (8 + 4 + 4) + 4
    fixed = 2 * d_tile * 16 + 2 * d_tile * itemsize + (2 + 32) * 4
    chunk = min(MAX_CHUNK, (SMEM_BUDGET - fixed) // per_row // 8 * 8)
    if chunk < 8:
        raise ValueError(f"segment_sum: a {d_tile}-column tile does not fit {SMEM_BUDGET} bytes")
    threads = WIDE_THREADS if d_tile >= WIDE_COLS else THREADS
    return dict(d_tile=d_tile, chunk=chunk, threads=threads, smem=chunk * per_row + fixed)


def segment_sum_plain(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """Plain torch version: `index_add_` of x's rows into p.n zero rows."""
    return x.new_zeros((p.n,) + tuple(x.shape[1:])).index_add_(0, p.idx, x)


def segment_sum(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """out [n, ...] with out[s] = sum of x[r] over rows r of segment s, in
    ascending r.  x [R, ...] float32 or float64."""
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
    shape = launch_shape(d, x.element_size())
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cusift_segment_sum(
            x.data_ptr(), p.order.data_ptr(), p.seg.data_ptr(),
            p.ends.data_ptr(), p.blocks.data_ptr(), out.data_ptr(), rows, p.n, d,
            p.blocks.shape[0] - 1, p.tile, shape["d_tile"], shape["chunk"],
            shape["threads"], shape["smem"], int(x.dtype == torch.float64), stream)
    _build.check(err, "cusift_segment_sum")
    trace.count("kernel.segment")
    return out

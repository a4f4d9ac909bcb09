"""K2: fused similarity + top-2 for the matcher (CUDA kernel `csrc/matcher.cu`).

Replaces the TPU kernel `cusift_tpu/ops/pallas/matcher.py:_pallas_top2`
(body `_kernel`): per query row, the best score s1 with its first index i1
and the second-best s2 (the max with column i1 removed) of A @ B.T with
invalid B columns at -inf.  The TPU kernel's VMEM cap on M
(`ops/match.py:50-53`) does not apply: B is streamed through shared memory.

Under `jax.vmap` the reference's `pallas_call` gains a frame axis on its
grid; so does this one.  Either side may carry a leading frame axis; a
side without it (the reference keyframe of a tracking chunk, the anchor
of a BA window) is shared by every frame with batch stride 0, not copied.
One batched call is one launch, and each frame's result equals its own
single call word for word.

What bounds it on the H100: arithmetic (2*N*M*D flops a frame).  The kernel runs
on the TF32 tensor cores with each operand split into two TF32 words
(3xTF32: three products per multiply-add), which keeps the scores within
~1e-6 of f32; it folds each tile of A @ B.T into a running top-2 and never
writes the [N, M] similarity.  The column range is cut into P splits so
that a few hundred query rows still fill the card; `_launch_plan` picks P
over all the frames' row blocks and a second pass merges the partial
top-2s.  See the source's header.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
`top2_plain`, which is also what the tests and `chip_smoke.py` hold the
kernel against.
"""

from __future__ import annotations

import functools

import torch

from ..utils import trace
from . import _build


BLOCK_ROWS = 128   # query rows per block (csrc/matcher.cu BM)
BLOCK_COLS = 64    # B rows per streamed tile (csrc/matcher.cu BN)
# cost of a block's A load and split, in B tiles, for `_launch_plan`
_A_TILES = 2


def _launch_plan(n: int, m: int, d: int, sms: int, frames: int = 1,
                 splits: int | None = None) -> dict:
    """Grid of K2 for `frames` frames of A [n, d] against B [m, d] on a card
    of `sms` SMs: row blocks x P column splits a frame (`grid`), times the
    frames (the launch's third axis).  P minimises waves x (tiles per split +
    the A load) with one block per SM over every frame's blocks; ties go to
    the smaller P.  `splits` forces P (tests).  With P > 1 the wrapper
    allocates [P, frames, n] partial top-2s (`scratch_rows`) that the
    second pass merges; with P == 1 the kernel writes the outputs."""
    if n <= 0 or m <= 0 or not 0 < d <= 128 or sms <= 0 or frames <= 0:
        raise ValueError(f"top2 plan: n={n}, m={m}, d={d}, sms={sms}, frames={frames}")
    row_blocks = -(-n // BLOCK_ROWS)
    tiles = -(-m // BLOCK_COLS)
    best = None
    for p in range(1, tiles + 1) if splits is None else (min(max(splits, 1), tiles),):
        per = -(-tiles // p)
        used = -(-tiles // per)            # no empty split
        cost = -(-frames * row_blocks * used // sms) * (per + _A_TILES)
        if best is None or cost < best[0]:
            best = (cost, used, per)
    _, used, per = best
    return dict(row_blocks=row_blocks, splits=used,
                cols_per_split=per * BLOCK_COLS,
                grid=(row_blocks, used), frames=frames,
                blocks=row_blocks * used * frames,
                scratch_rows=used * frames * n if used > 1 else 0)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def top2_plain(desc_a: torch.Tensor, desc_b: torch.Tensor,
               valid_b: torch.Tensor):
    """Plain torch version: dense similarity, then max / argmax passes;
    the same leading frame axes as `top2`, broadcast."""
    sim = desc_a.to(torch.float32) @ desc_b.to(torch.float32).transpose(-1, -2)
    sim = torch.where(valid_b[..., None, :], sim, torch.full_like(sim, -torch.inf))
    s1 = sim.max(dim=-1).values
    i1 = torch.argmax(sim, dim=-1)      # documented first index on ties
    cols = torch.arange(sim.shape[-1], device=sim.device)
    s2 = torch.where(cols == i1[..., None],
                     torch.full_like(sim, -torch.inf), sim).max(dim=-1).values
    return torch.stack([s1, s2], -1), i1.to(torch.int32)


def _frames(desc_a, desc_b, valid_b) -> int | None:
    """The frame count of the inputs' leading axes (None when no input has
    one); raises on ranks or counts that do not agree."""
    ranks = ((desc_a, 2), (desc_b, 2), (valid_b, 1))
    if any(t.ndim not in (r, r + 1) for t, r in ranks):
        raise ValueError(f"top2: ranks desc_a {desc_a.ndim}, desc_b {desc_b.ndim}, "
                         f"valid_b {valid_b.ndim}")
    counts = {t.shape[0] for t, r in ranks if t.ndim == r + 1}
    if len(counts) > 1:
        raise ValueError(f"top2: frame counts {sorted(counts)} differ")
    return counts.pop() if counts else None


def top2(desc_a: torch.Tensor, desc_b: torch.Tensor, valid_b: torch.Tensor,
         splits: int | None = None):
    """Best / second-best similarity of each A row against valid B rows.

    desc_a [N, D] or [B, N, D], desc_b [M, D] or [B, M, D] float32,
    valid_b [M] or [B, M] bool; a side without the frame axis is shared by
    the B frames.  Returns (top [..., N, 2] = (s1, s2) float32, idx
    [..., N] int32), with the frame axis when any input has one: one
    launch for the batch.  `splits` forces the plan's column splits
    (tests).
    """
    if desc_a.device.type == "cpu":
        return top2_plain(desc_a, desc_b, valid_b)
    if desc_a.device.type != "cuda":
        raise ValueError(f"top2: no kernel for {desc_a.device}")
    frames = _frames(desc_a, desc_b, valid_b)
    n, d = desc_a.shape[-2:]
    m = desc_b.shape[-2]
    for name, t, dtype in (("desc_a", desc_a, torch.float32),
                           ("desc_b", desc_b, torch.float32),
                           ("valid_b", valid_b, torch.bool)):
        if t.device != desc_a.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"top2: {name} must be a contiguous {dtype} tensor "
                             f"on {desc_a.device}, got {t.dtype} on {t.device}")
    if desc_b.shape[-1] != d or valid_b.shape[-1] != m or not 0 < d <= 128:
        raise ValueError(f"top2: shapes desc_a {tuple(desc_a.shape)}, desc_b "
                         f"{tuple(desc_b.shape)}, valid_b {tuple(valid_b.shape)}")
    lead = () if frames is None else (frames,)
    nb = 1 if frames is None else frames
    top = torch.empty(lead + (n, 2), dtype=torch.float32, device=desc_a.device)
    idx = torch.empty(lead + (n,), dtype=torch.int32, device=desc_a.device)
    if n == 0 or nb == 0:
        return top, idx
    if m == 0:
        top.fill_(-torch.inf)
        idx.zero_()
        return top, idx
    plan = _launch_plan(n, m, d, _sm_count(desc_a.device.index), nb, splits)
    p = plan["splits"]
    part_top = part_idx = None
    if p > 1:
        part_top = torch.empty((p, nb, n, 2), dtype=torch.float32, device=desc_a.device)
        part_idx = torch.empty((p, nb, n), dtype=torch.int32, device=desc_a.device)
    # batch strides in elements; a side without the frame axis is shared
    strides = [t.shape[-2] * t.shape[-1] if t.ndim == 3 else 0 for t in (desc_a, desc_b)]
    strides.append(m if valid_b.ndim == 2 else 0)
    lib = _build.library()
    with torch.cuda.device(desc_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cusift_match_top2(
            desc_a.data_ptr(), desc_b.data_ptr(), valid_b.data_ptr(),
            top.data_ptr(), idx.data_ptr(),
            None if part_top is None else part_top.data_ptr(),
            None if part_idx is None else part_idx.data_ptr(),
            nb, n, m, d, *strides, p, plan["cols_per_split"], stream)
    _build.check(err, "cusift_match_top2")
    trace.count("kernel.matcher")
    return top, idx

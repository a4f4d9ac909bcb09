"""The gradient samplers K1, K4, K5 and K6 (CUDA kernels `csrc/sampler.cu`).

Each replaces one TPU kernel of `cusift_tpu/ops/pallas/sampler.py`:

* K1 `sample_grad_patches` (body `_kernel`): bilinear gradients at [N, S]
  points;
* K4 `sample_ori_hist` (`_kernel_hist`): K1's sampling, then the soft
  circular orientation histogram of each slot;
* K5 `sample_desc_raw` (`_kernel_desc`): K1's sampling, then the raw
  [nb, cells] descriptor histogram of each slot;
* K6 `sample_grad_patches_sep` (`_kernel_sep`): K1's sampling on an
  axis-aligned [GR x GC] grid per slot.

Their semantics are those of the reference's XLA path
(`ops/sampling.py:bilinear_sample_pair` over `ops/gaussian.py:image_gradients`,
and the binning formulas of `ops/orientation.py` and `ops/describe.py`), in
float32: the TPU tiling (patch sizes, (8, 128) corner rounding, slot group
G), the bf16 dots and the polynomial atan2 have no meaning on the GPU and
are not carried over.

What bounds them on the H100: the bytes of the level pixels the points
read and of the per-sample inputs, and the latency of the scattered corner
loads (K1 and K6 load each of a sample's 12 distinct floats once).  K4 and
K5 add a histogram per slot whose dense form is ~96% exact zeros (a
sample weighs on two of nb bins; the descriptor's spatial weights are
~86% zeros), so they sum only the non-zero terms, in the order and with
the expressions of a dense sum, which keeps its bits.  `_launch_plan`
packs several slots into a block, so that every thread has samples to
bin and outputs to own, and cuts the samples into chunks that fit 48 KB
of shared memory; see the source's header for the design.

Each kernel takes a batch of frames, as the TPU kernels' grid does under
`jax.vmap`: the level stacks [B, L, H, W] and each frame's slots [B, N, ...]
in one launch, a slot's level clipped within its frame.  A [L, H, W] stack
with [N, ...] slots is the B = 1 case.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
`*_plain` version, the same math in plain torch over any leading frame
axes, which is also what the tests and `chip_smoke.py` hold the kernel
against.
"""

from __future__ import annotations

import math

import torch

from ..ops.gaussian import image_gradients
from ..utils import trace
from . import _build
from .matcher import _sm_count


def _planes(lvl: torch.Tensor, nlev: int) -> torch.Tensor:
    """Plane of each slot [..., N] in its stack's frames flattened to
    [B * L]: frame * L + lvl clipped to [0, L - 1], so a level is clipped
    within its own frame (vmap gives each frame its own [L, H, W])."""
    frames = torch.arange(math.prod(lvl.shape[:-1]), device=lvl.device)
    return (frames.reshape(lvl.shape[:-1] + (1,)) * nlev
            + lvl.to(torch.int64).clamp(0, nlev - 1))


def bilinear_sample_pair(stack2: torch.Tensor, lvl: torch.Tensor,
                         ys: torch.Tensor, xs: torch.Tensor):
    """Bilinear-sample two channels of stack2 [..., L, H, W, 2] at (ys, xs).

    lvl: [..., N] int; ys, xs: [..., N, S] float32, with the stack's
    leading (frame) axes.  Returns (v0 [..., N, S], v1 [..., N, S],
    in_bounds [..., N, S]).  Indices are clamped like the reference's
    `GatherScatterMode.CLIP`, the level within the slot's frame.  A NaN
    point (a dead slot whose refined scale overflowed) samples (0, 0) and
    is out of bounds, as in the kernels, whose fmaxf drops the NaN.
    """
    l, h, w, _ = stack2.shape[-4:]
    inb = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    ys = ys.nan_to_num(0.0).clamp(0.0, h - 1.000001)
    xs = xs.nan_to_num(0.0).clamp(0.0, w - 1.000001)
    y0 = torch.floor(ys).to(torch.int64).clamp(max=h - 2)
    x0 = torch.floor(xs).to(torch.int64).clamp(max=w - 2)
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]
    flat = stack2.reshape(-1, h, w, 2)
    li = _planes(lvl, l)[..., None]
    c00 = flat[li, y0, x0]
    c01 = flat[li, y0, x0 + 1]
    c10 = flat[li, y0 + 1, x0]
    c11 = flat[li, y0 + 1, x0 + 1]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    v = top * (1 - fy) + bot * fy
    return v[..., 0], v[..., 1], inb


def soft_bins(fbin: torch.Tensor, nb: int) -> torch.Tensor:
    """[..., nb] weights max(0, 1 - circular distance) of fractional bins."""
    bins = torch.arange(nb, dtype=fbin.dtype, device=fbin.device)
    dist = (fbin[..., None] - bins).abs()
    dist = torch.minimum(dist, nb - dist)
    return torch.clamp(1.0 - dist, min=0.0)


def _fbin(ang: torch.Tensor, nb: int) -> torch.Tensor:
    return torch.remainder(ang / (2.0 * math.pi) * nb, nb)


def orientation_bins(dx, dy, inb, wv, nb: int) -> torch.Tensor:
    """[..., K, nb] histograms of gradient angles weighted by mag * wv * inb.

    A product and a sum over the sample axis, not a contraction: a sum
    over a short outer axis adds each output's terms in one order however
    many slots there are, where a GEMM's blocking moves with the row count,
    so a frame's histograms do not depend on the batch around it."""
    mag = torch.sqrt(dx * dx + dy * dy)
    w = mag * wv * inb
    return (w[..., None] * soft_bins(_fbin(torch.atan2(dy, dx), nb), nb)).sum(-2)


def descriptor_contrib(dx, dy, inb, theta, wv, nb: int) -> torch.Tensor:
    """[..., N, S, nb] soft bins of (theta - angle) weighted by mag * wv * inb."""
    mag = torch.sqrt(dx * dx + dy * dy)
    # gradient direction in the keypoint frame, y-up angle convention
    ang = theta[..., None] - torch.atan2(dy, dx)
    w = mag * wv * inb
    return soft_bins(_fbin(ang, nb), nb) * w[..., None]


def sample_grad_patches_plain(gauss: torch.Tensor, lvl: torch.Tensor,
                              ys: torch.Tensor, xs: torch.Tensor):
    """Plain torch version of K1: gradient planes + bilinear gather."""
    gdx, gdy = image_gradients(gauss)
    return bilinear_sample_pair(torch.stack([gdx, gdy], -1), lvl, ys, xs)


def _grid(ys_rows: torch.Tensor, xs_cols: torch.Tensor):
    """K6's grid as K1's points [..., N, GR * GC], point (n, r * GC + c)."""
    shape = ys_rows.shape + xs_cols.shape[-1:]
    return (ys_rows[..., :, None].expand(shape).flatten(-2),
            xs_cols[..., None, :].expand(shape).flatten(-2))


def sample_grad_patches_sep_plain(gauss, lvl, ys_rows, xs_cols):
    """Plain torch version of K6: K1's plain version on the expanded grid."""
    return sample_grad_patches_plain(gauss, lvl, *_grid(ys_rows, xs_cols))


def sample_ori_hist_plain(gauss, lvl, ys, xs, wv, nb: int) -> torch.Tensor:
    """Plain torch version of K4: K1's plain sampling + `orientation_bins`."""
    dx, dy, inb = sample_grad_patches_plain(gauss, lvl, ys, xs)
    return orientation_bins(dx, dy, inb, wv, nb)


def sample_desc_raw_plain(gauss, lvl, ys, xs, theta, wv, w_spatial,
                          nb: int) -> torch.Tensor:
    """Plain torch version of K5: [..., N, nb, cells], bins major (a
    product and a sum over the samples, as `orientation_bins`)."""
    dx, dy, inb = sample_grad_patches_plain(gauss, lvl, ys, xs)
    contrib = descriptor_contrib(dx, dy, inb, theta, wv, nb)
    return (contrib[..., None] * w_spatial[:, None, :]).sum(-3)


def _checked(fn: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous tensor of its dtype on device.

    tensors: name -> (tensor, dtype)."""
    for name, (t, dtype) in tensors.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor "
                             f"on {device}, got {t.dtype} on {t.device}")


def _plain_or_cuda(fn: str, gauss: torch.Tensor) -> bool:
    """True for a CPU stack (take the plain version); raise off CUDA."""
    if gauss.device.type == "cpu":
        return True
    if gauss.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {gauss.device}")
    if (gauss.ndim not in (3, 4) or min(gauss.shape[:-2]) < 1 or gauss.shape[-2] < 2
            or gauss.shape[-1] < 2):
        raise ValueError(f"{fn}: level stack {tuple(gauss.shape)}")
    return False


def _frames(gauss: torch.Tensor, *slot_tensors):
    """The kernels' batched form: a [L, H, W] stack with [N, ...] slot
    tensors is the B = 1 case of [B, L, H, W] with [B, N, ...].  Returns
    (the 4-D stack, the slot tensors with their frame axis, a function that
    drops that axis again from the B = 1 case's outputs)."""
    if gauss.ndim == 4:
        return gauss, slot_tensors, lambda *outs: outs
    return gauss[None], tuple(t[None] for t in slot_tensors), \
        lambda *outs: tuple(o[0] for o in outs)


def _launch(fn: str, gauss: torch.Tensor, *args) -> None:
    lib = _build.library()
    with torch.cuda.device(gauss.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, stream)
    _build.check(err, fn)


def _ptrs(*tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


def sample_grad_patches(gauss: torch.Tensor, lvl: torch.Tensor,
                        ys: torch.Tensor, xs: torch.Tensor):
    """K1: image gradients of `gauss` [B, L, H, W] at (ys, xs) [B, N, S].

    lvl: [B, N] int32 level per slot (clipped to [0, L-1] within its
    frame).  Returns (dx [B, N, S] f32, dy [B, N, S] f32, inb [B, N, S]
    bool).  A [L, H, W] stack with [N], [N, S] inputs is the B = 1 case
    and gives [N, S] outputs.
    """
    if _plain_or_cuda("sample_grad_patches", gauss):
        return sample_grad_patches_plain(gauss, lvl, ys, xs)
    f32 = torch.float32
    _checked("sample_grad_patches", gauss.device, gauss=(gauss, f32),
             lvl=(lvl, torch.int32), ys=(ys, f32), xs=(xs, f32))
    gauss, (lvl, ys, xs), unbatch = _frames(gauss, lvl, ys, xs)
    b, l, h, w = gauss.shape
    n, s = ys.shape[1:]
    if lvl.shape != (b, n) or xs.shape != (b, n, s) or ys.shape[0] != b:
        raise ValueError(f"sample_grad_patches: shapes lvl {tuple(lvl.shape)}, "
                         f"ys {tuple(ys.shape)}, xs {tuple(xs.shape)} for {b} frames")
    dx = torch.empty((b, n, s), dtype=f32, device=gauss.device)
    dy = torch.empty_like(dx)
    inb = torch.empty((b, n, s), dtype=torch.bool, device=gauss.device)
    if b * n * s == 0:
        return unbatch(dx, dy, inb)
    _launch("cusift_sample_grad_patches", gauss,
            *_ptrs(gauss, lvl, ys, xs, dx, dy, inb), l, h, w, b, n, s)
    trace.count("kernel.sampler")
    return unbatch(dx, dy, inb)


def sample_grad_patches_sep(gauss: torch.Tensor, lvl: torch.Tensor,
                            ys_rows: torch.Tensor, xs_cols: torch.Tensor):
    """K6: gradients of `gauss` [B, L, H, W] on the per-slot grid
    ys_rows [B, N, GR] x xs_cols [B, N, GC] (lvl [B, N]).

    Returns (dx, dy, inb) shaped [B, N, GR*GC] in row-major (r * GC + c)
    order; inb is row-in & col-in.  [L, H, W] with [N, ...] inputs is the
    B = 1 case.
    """
    if _plain_or_cuda("sample_grad_patches_sep", gauss):
        return sample_grad_patches_sep_plain(gauss, lvl, ys_rows, xs_cols)
    f32 = torch.float32
    _checked("sample_grad_patches_sep", gauss.device, gauss=(gauss, f32),
             lvl=(lvl, torch.int32), ys_rows=(ys_rows, f32), xs_cols=(xs_cols, f32))
    gauss, (lvl, ys_rows, xs_cols), unbatch = _frames(gauss, lvl, ys_rows, xs_cols)
    b, l, h, w = gauss.shape
    n, gr = ys_rows.shape[1:]
    if (lvl.shape != (b, n) or ys_rows.shape[0] != b or xs_cols.ndim != 3
            or xs_cols.shape[:2] != (b, n)):
        raise ValueError(f"sample_grad_patches_sep: shapes lvl {tuple(lvl.shape)}, "
                         f"ys_rows {tuple(ys_rows.shape)}, xs_cols {tuple(xs_cols.shape)} "
                         f"for {b} frames")
    gc = xs_cols.shape[2]
    if b * n * gr * gc >= 2**31 or b * l * h * w >= 2**31:
        raise ValueError(f"sample_grad_patches_sep: {b} x {n} slots of {gr} x {gc} on "
                         f"{b} x {l} x {h} x {w} stacks: the kernel's 32-bit index takes "
                         "fewer than 2^31 samples and pixels")
    dx = torch.empty((b, n, gr * gc), dtype=f32, device=gauss.device)
    dy = torch.empty_like(dx)
    inb = torch.empty((b, n, gr * gc), dtype=torch.bool, device=gauss.device)
    if b * n * gr * gc == 0:
        return unbatch(dx, dy, inb)
    _launch("cusift_sample_grad_patches_sep", gauss,
            *_ptrs(gauss, lvl, ys_rows, xs_cols, dx, dy, inb), l, h, w, b, n, gr, gc)
    trace.count("kernel.sep")
    return unbatch(dx, dy, inb)


MAX_SAMPLES = 4096   # K4/K5: samples per slot the wrappers take

SLOT_THREADS = 256          # K4/K5: threads of a block where a launch fills the card
MAX_THREADS = 1024          # csrc kSlotThreads
SM_THREADS = 2048           # resident threads of an SM (Hopper)
SMEM_BUDGET = 48 * 1024     # K4/K5: dynamic shared memory without the opt-in
BLOCK_SAMPLES = 512         # K4/K5: samples of a block, so slots = 512 // S


def _launch_plan(n: int, s: int, cells: int | None, sms: int) -> dict:
    """Grid of K4 (cells None) or K5 for n slots of s samples on `sms` SMs.

    A block holds `slots` = BLOCK_SAMPLES // s slots (3 at 144 samples),
    but no more than leave every SM a block.  Where the launch's samples
    fill the card's resident threads, a block has SLOT_THREADS threads,
    each binning about two samples and owning a few outputs; where they do
    not, a block has a thread for each sample of its chunk, so the launch
    waits for one sample's loads and no more.  The samples go in chunks of
    `chunk`, the most that fit SMEM_BUDGET: a 16-byte record per (slot,
    sample), and for K5 an 8-byte list entry per (cell, sample), at an odd
    pitch, and a list length per cell.  The bin count does not change the
    plan: outputs beyond the threads are walked in turn.  Chosen from a
    sweep of slots and threads at the batch's octave shapes on an H100.
    """
    if n <= 0 or s <= 0 or (cells is not None and cells <= 0) or sms <= 0:
        raise ValueError(f"K4/K5 plan: n={n}, s={s}, cells={cells}, sms={sms}")
    slots = max(1, min(BLOCK_SAMPLES // s, n // sms))
    # K5's lists have an odd pitch (csrc list_pitch): one spare entry each
    per_sample = 16 * slots + (8 * cells if cells is not None else 0)
    fixed = 12 * cells if cells is not None else 0
    chunk = min(s, (SMEM_BUDGET - fixed) // per_sample)
    if chunk < 1:
        raise ValueError(f"K4/K5 plan: {cells} cells do not fit {SMEM_BUDGET} bytes")
    if n * s >= sms * SM_THREADS:
        threads = SLOT_THREADS
    else:
        threads = min(MAX_THREADS, -(-slots * chunk // 32) * 32)
    smem = 16 * slots * chunk
    if cells is not None:
        smem += 8 * cells * (chunk | 1) + 4 * cells
    return dict(slots=slots, threads=threads, chunk=chunk, chunks=-(-s // chunk),
                smem_bytes=smem, blocks=-(-n // slots))


def _plan_args(plan: dict) -> tuple[int, int, int, int]:
    return plan["slots"], plan["chunk"], plan["threads"], plan["smem_bytes"]


def _check_slots(fn: str, gauss, lvl, ys, xs, wv) -> tuple[int, int, int]:
    """(B, N, S) of K4's or K5's batched inputs, checked."""
    f32 = torch.float32
    _checked(fn, gauss.device, gauss=(gauss, f32), lvl=(lvl, torch.int32),
             ys=(ys, f32), xs=(xs, f32), wv=(wv, f32))
    b = gauss.shape[0]
    n, s = ys.shape[1:]
    if (lvl.shape != (b, n) or ys.shape[0] != b or xs.shape != (b, n, s)
            or wv.shape != (b, n, s)):
        raise ValueError(f"{fn}: shapes lvl {tuple(lvl.shape)}, ys {tuple(ys.shape)}, "
                         f"xs {tuple(xs.shape)}, wv {tuple(wv.shape)} for {b} frames")
    if s > MAX_SAMPLES:
        raise ValueError(f"{fn}: {s} samples per slot, at most {MAX_SAMPLES}")
    return b, n, s


def sample_ori_hist(gauss: torch.Tensor, lvl: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor, wv: torch.Tensor, nb: int) -> torch.Tensor:
    """K4: orientation histograms [B, N, nb] of the slots' sample points.

    gauss [B, L, H, W], lvl [B, N], ys/xs [B, N, S]; wv [B, N, S]:
    per-sample weight (radial Gaussian x keypoint validity); a sample
    outside the image weighs nothing.  Smoothing stays outside.  [L, H, W]
    with [N, ...] inputs is the B = 1 case.
    """
    if _plain_or_cuda("sample_ori_hist", gauss):
        return sample_ori_hist_plain(gauss, lvl, ys, xs, wv, nb)
    gauss, (lvl, ys, xs, wv), unbatch = _frames(gauss, lvl, ys, xs, wv)
    b, n, s = _check_slots("sample_ori_hist", gauss, lvl, ys, xs, wv)
    hist = torch.empty((b, n, nb), dtype=torch.float32, device=gauss.device)
    if b * n * s == 0 or nb == 0:
        return unbatch(hist.zero_())[0]
    l, h, w = gauss.shape[1:]
    plan = _launch_plan(b * n, s, None, _sm_count(gauss.device.index))
    _launch("cusift_sample_ori_hist", gauss, *_ptrs(gauss, lvl, ys, xs, wv, hist),
            l, h, w, b, n, s, nb, *_plan_args(plan))
    trace.count("kernel.ori_hist")
    return unbatch(hist)[0]


def sample_desc_raw(gauss: torch.Tensor, lvl: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor, theta: torch.Tensor, wv: torch.Tensor,
                    w_spatial: torch.Tensor, nb: int) -> torch.Tensor:
    """K5: raw descriptor histograms [B, N, nb, cells], bins major.

    gauss [B, L, H, W], lvl [B, N], ys/xs [B, N, S]; theta [B, N] slot
    orientations; wv [B, N, S] spatial Gaussian weights; w_spatial
    [S, cells] static bilinear cell weights, shared by the frames.
    Normalisation stays outside.  [L, H, W] with [N, ...] inputs is the
    B = 1 case.
    """
    if _plain_or_cuda("sample_desc_raw", gauss):
        return sample_desc_raw_plain(gauss, lvl, ys, xs, theta, wv, w_spatial, nb)
    gauss, (lvl, ys, xs, theta, wv), unbatch = _frames(gauss, lvl, ys, xs, theta, wv)
    b, n, s = _check_slots("sample_desc_raw", gauss, lvl, ys, xs, wv)
    f32 = torch.float32
    _checked("sample_desc_raw", gauss.device, theta=(theta, f32),
             w_spatial=(w_spatial, f32))
    if theta.shape != (b, n) or w_spatial.ndim != 2 or w_spatial.shape[0] != s:
        raise ValueError(f"sample_desc_raw: shapes theta {tuple(theta.shape)}, "
                         f"w_spatial {tuple(w_spatial.shape)} for [{b}, {n}, {s}] samples")
    cells = w_spatial.shape[1]
    raw = torch.empty((b, n, nb, cells), dtype=f32, device=gauss.device)
    if b * n * s == 0 or nb * cells == 0:
        return unbatch(raw.zero_())[0]
    l, h, w = gauss.shape[1:]
    plan = _launch_plan(b * n, s, cells, _sm_count(gauss.device.index))
    _launch("cusift_sample_desc_raw", gauss,
            *_ptrs(gauss, lvl, ys, xs, theta, wv, w_spatial, raw),
            l, h, w, b, n, s, nb, cells, *_plan_args(plan))
    trace.count("kernel.desc_raw")
    return unbatch(raw)[0]

"""Plain PyTorch reference for the benchmark's output check.

It imports nothing of the program.  From the benchmark's own inputs (the
images and depth maps it made) it works out again, in float64, what the
program derived from them, at the places the program's outputs name:

* the scale space (`pyramid`), each keypoint's refined position and scale
  (`refine`: the quadratic fit at the DoG extremum the program's keypoint
  came from), the orientation peaks at a keypoint (`orientation_peaks`)
  and its 128-d descriptor (`descriptors`);
* the ratio-test top-2 over the program's descriptors (`ratio_match`);
* the least-squares homography or rigid motion over the correspondences
  the program kept as inliers (`fit_homography`, `fit_rigid`), from the
  reference's own 3-D points for RGB-D frames;
* a keyframe window's BA objective, its optimum in float64 and the
  landmarks' optimum at given poses (`window_observations`,
  `bundle_adjust`, `ba_left`);
* SlamConfig's keyframe gates applied to a frame's tracking row
  (`needs_keyframe`).

The formulas are the published ones the program implements (Lowe's SIFT
with a fixed sampling grid: reflect-101 Gaussian blurs, a 36-bin
orientation histogram smoothed [1 4 6 4 1]/16 with parabolic peaks, a 4x4x8
descriptor with bilinear cell weights, clipped at 0.2).

`Prec` selects the arithmetic: `F64` is the judge; `TF32` is the control,
float32 with every matmul and convolution operand rounded to TF32's
10-bit mantissa, as the tensor cores' TF32 path does, the nearest step
below the program's float32 with TF32 off.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Prec(NamedTuple):
    dtype: torch.dtype
    tf32: bool


F64 = Prec(torch.float64, False)
TF32 = Prec(torch.float32, True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to 10 mantissa bits, to nearest, ties to even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & -8192).view(torch.float32)


def _op(x: torch.Tensor, p: Prec) -> torch.Tensor:
    """An operand of a matmul or a convolution in precision p."""
    x = x.to(p.dtype)
    return round_tf32(x) if p.tf32 else x


def mm(a: torch.Tensor, b: torch.Tensor, p: Prec) -> torch.Tensor:
    return torch.matmul(_op(a, p), _op(b, p))


# ---------------------------------------------------------------- pyramid

def gaussian_taps(sigma: float) -> torch.Tensor:
    """1-D Gaussian taps of radius max(1, ceil(4 sigma)), summing to 1."""
    r = max(1, int(math.ceil(4.0 * sigma)))
    x = torch.arange(-r, r + 1, dtype=torch.float64)
    t = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return t / t.sum()


def blur(img: torch.Tensor, sigma: float, p: Prec) -> torch.Tensor:
    """Separable Gaussian blur of [H, W], reflect-101 borders, rows first."""
    if sigma <= 0.0:
        return img
    taps = _op(gaussian_taps(sigma).to(img.device), p)
    r = (taps.numel() - 1) // 2
    x = _op(img, p)[None, None]
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), taps.view(1, 1, -1, 1))
    x = _op(x, p)
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), taps.view(1, 1, 1, -1))
    return x[0, 0]


def num_octaves(sift: dict, h: int, w: int) -> int:
    base = min(h, w) * (2 if sift["upscale"] else 1)
    if base < 16:
        return 1
    return min(sift["num_octaves"], int(math.log2(base / 8.0)))


def level_sigmas(sift: dict) -> list[float]:
    s = sift["scales_per_octave"]
    k = 2.0 ** (1.0 / s)
    return [sift["sigma0"] * k ** i for i in range(s + 3)]


def pyramid(img: torch.Tensor, sift: dict, p: Prec) -> list[torch.Tensor]:
    """Gaussian levels [S + 3, h, w] of each octave of a [H, W] image."""
    img = img.to(p.dtype)
    if sift["upscale"]:
        base = F.interpolate(img[None, None], scale_factor=2, mode="bilinear",
                             align_corners=False)[0, 0]
        assumed = sift["init_blur"] * 2.0
    else:
        base, assumed = img, sift["init_blur"]
    base = blur(base, max(sift["sigma0"] ** 2 - assumed ** 2, 0.01) ** 0.5, p)
    sig = level_sigmas(sift)
    inc = [math.sqrt(max(sig[i] ** 2 - sig[i - 1] ** 2, 1e-12)) for i in range(1, len(sig))]
    octaves = []
    for _ in range(num_octaves(sift, *img.shape)):
        levels = [base]
        for s in inc:
            levels.append(blur(levels[-1], s, p))
        octaves.append(torch.stack(levels))
        base = levels[sift["scales_per_octave"]][::2, ::2]
    return octaves


# ---------------------------------------------------------------- keypoints

class Refined(NamedTuple):
    xo: torch.Tensor        # [K] octave-local column
    yo: torch.Tensor
    so: torch.Tensor        # refined level coordinate
    level: torch.Tensor     # [K] int64 DoG level of the extremum (1..S)
    cell_x: torch.Tensor    # [K] int64 integer column and row of the extremum
    cell_y: torch.Tensor
    gap: torch.Tensor       # [K] max |program - reference| over (xo, yo, so)


def _fit(dog: torch.Tensor, lvl, y, x):
    """Quadratic fit of the DoG at integer cells: (offset [K, 3], ok)."""
    s, h, w = dog.shape
    d = torch.arange(-1, 2, device=dog.device)
    ll = (lvl[:, None] + d).clamp(0, s - 1)
    yy = (y[:, None] + d).clamp(0, h - 1)
    xx = (x - 1).clamp(0, w - 3)[:, None] + d + 1
    c = dog[ll[:, :, None, None], yy[:, None, :, None], xx[:, None, None, :]]
    v = c[:, 1, 1, 1]
    g = torch.stack([0.5 * (c[:, 1, 1, 2] - c[:, 1, 1, 0]),
                     0.5 * (c[:, 1, 2, 1] - c[:, 1, 0, 1]),
                     0.5 * (c[:, 2, 1, 1] - c[:, 0, 1, 1])], -1)
    dxx = c[:, 1, 1, 2] - 2 * v + c[:, 1, 1, 0]
    dyy = c[:, 1, 2, 1] - 2 * v + c[:, 1, 0, 1]
    dss = c[:, 2, 1, 1] - 2 * v + c[:, 0, 1, 1]
    dxy = 0.25 * (c[:, 1, 2, 2] - c[:, 1, 2, 0] - c[:, 1, 0, 2] + c[:, 1, 0, 0])
    dxs = 0.25 * (c[:, 2, 1, 2] - c[:, 2, 1, 0] - c[:, 0, 1, 2] + c[:, 0, 1, 0])
    dys = 0.25 * (c[:, 2, 2, 1] - c[:, 2, 0, 1] - c[:, 0, 2, 1] + c[:, 0, 0, 1])
    hess = torch.stack([torch.stack([dxx, dxy, dxs], -1), torch.stack([dxy, dyy, dys], -1),
                        torch.stack([dxs, dys, dss], -1)], -2)
    off, info = torch.linalg.solve_ex(hess, -g)
    return off, (info == 0) & torch.isfinite(off).all(-1)


def refine(gauss: torch.Tensor, xo: torch.Tensor, yo: torch.Tensor,
           so: torch.Tensor, sift: dict) -> Refined:
    """The DoG extremum each program keypoint (octave-local xo, yo, so) came
    from, refined again: each of the 2 x 2 x 2 integer cells within one
    unit of it (a refined offset stays under 1) is fitted, and the one whose
    fit lands nearest the program's keypoint is its cell."""
    dog = gauss[1:] - gauss[:-1]
    s_levels, h, w = dog.shape
    best_gap = torch.full(xo.shape, math.inf, dtype=dog.dtype, device=dog.device)
    best = [torch.zeros_like(best_gap) for _ in range(3)]
    best_l = torch.ones(xo.shape, dtype=torch.int64, device=dog.device)
    best_x, best_y = torch.ones_like(best_l), torch.ones_like(best_l)
    x0, y0, l0 = (torch.floor(v.to(dog.dtype)).long() for v in (xo, yo, so))
    target = torch.stack([xo, yo, so], -1).to(dog.dtype)
    for dl in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                x = (x0 + dx).clamp(1, w - 2)
                y = (y0 + dy).clamp(1, h - 2)
                lvl = (l0 + dl).clamp(1, s_levels - 2)
                off, ok = _fit(dog, lvl, y, x)
                fit = torch.stack([x, y, lvl], -1).to(dog.dtype) + off
                gap = (fit - target).abs().amax(-1)
                gap = torch.where(ok & (off.abs() < 1.0).all(-1), gap,
                                  torch.full_like(gap, math.inf))
                take = gap < best_gap
                best_gap = torch.where(take, gap, best_gap)
                for i in range(3):
                    best[i] = torch.where(take, fit[:, i], best[i])
                best_l = torch.where(take, lvl, best_l)
                best_x = torch.where(take, x, best_x)
                best_y = torch.where(take, y, best_y)
    return Refined(xo=best[0], yo=best[1], so=best[2], level=best_l, cell_x=best_x,
                   cell_y=best_y, gap=best_gap)


def refit(gauss: torch.Tensor, at: Refined) -> Refined:
    """The fit at the cells another refinement found, in gauss's precision;
    `gap` is the distance to that refinement."""
    off, ok = _fit(gauss[1:] - gauss[:-1], at.level, at.cell_y, at.cell_x)
    fit = torch.stack([at.cell_x, at.cell_y, at.level], -1).to(gauss.dtype) + off
    other = torch.stack([at.xo, at.yo, at.so], -1)
    gap = (fit.to(other.dtype) - other).abs().amax(-1)
    gap = torch.where(ok, gap, torch.full_like(gap, math.inf))
    return at._replace(xo=fit[:, 0], yo=fit[:, 1], so=fit[:, 2], gap=gap)


# ---------------------------------------------------------------- sampling

def sample_gradients(gauss: torch.Tensor, level: torch.Tensor,
                     ys: torch.Tensor, xs: torch.Tensor):
    """Bilinear samples of the gradient planes of each point's level:
    (dx, dy, in_bounds), each [K, S].  A point past the border samples the
    clamped border and is out of bounds."""
    _, h, w = gauss.shape
    inb = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    ys = ys.nan_to_num(0.0).clamp(0.0, h - 1.000001)
    xs = xs.nan_to_num(0.0).clamp(0.0, w - 1.000001)
    y0 = torch.floor(ys).long().clamp(max=h - 2)
    x0 = torch.floor(xs).long().clamp(max=w - 2)
    fy, fx = ys - y0, xs - x0
    out = []
    for plane in gradient_planes(gauss):
        li = level[:, None]
        top = plane[li, y0, x0] * (1 - fx) + plane[li, y0, x0 + 1] * fx
        bot = plane[li, y0 + 1, x0] * (1 - fx) + plane[li, y0 + 1, x0 + 1] * fx
        out.append(top * (1 - fy) + bot * fy)
    return out[0], out[1], inb


def gradient_planes(gauss: torch.Tensor):
    """Central differences (dx, dy) of each [L, H, W] level, zero on the
    border rows and columns."""
    dx = torch.zeros_like(gauss)
    dy = torch.zeros_like(gauss)
    dx[:, :, 1:-1] = 0.5 * (gauss[:, :, 2:] - gauss[:, :, :-2])
    dy[:, 1:-1, :] = 0.5 * (gauss[:, 2:, :] - gauss[:, :-2, :])
    return dx, dy


def soft_bins(fbin: torch.Tensor, nb: int) -> torch.Tensor:
    bins = torch.arange(nb, dtype=fbin.dtype, device=fbin.device)
    dist = (fbin[..., None] - bins).abs()
    return torch.clamp(1.0 - torch.minimum(dist, nb - dist), min=0.0)


def _fbin(ang: torch.Tensor, nb: int) -> torch.Tensor:
    return torch.remainder(ang / (2.0 * math.pi) * nb, nb)


def orientation_peaks(gauss: torch.Tensor, r: Refined, sift: dict):
    """Every local peak of each keypoint's smoothed orientation histogram,
    parabola-refined: (theta [K, nb] radians, is_peak [K, nb])."""
    g, nb, s = sift["ori_grid"], sift["ori_bins"], sift["scales_per_octave"]
    dev, dt = gauss.device, gauss.dtype
    c1d = (torch.arange(g, dtype=dt, device=dev) + 0.5) / g * 2.0 - 1.0
    vy, vx = torch.meshgrid(c1d, c1d, indexing="ij")
    radius = sift["ori_radius_factor"] * sift["sigma0"] * torch.pow(2.0, r.so / s)
    ys = (r.yo[:, None] + radius[:, None] * vy.flatten())
    xs = (r.xo[:, None] + radius[:, None] * vx.flatten())
    r2 = (vy.flatten() ** 2 + vx.flatten() ** 2) * sift["ori_radius_factor"] ** 2
    wgt = torch.exp(-r2 / (2.0 * sift["ori_sigma_factor"] ** 2))
    wgt = wgt * (r2 <= sift["ori_radius_factor"] ** 2)
    dx, dy, inb = sample_gradients(gauss, r.level, ys, xs)
    w = torch.sqrt(dx * dx + dy * dy) * wgt * inb
    hist = (w[..., None] * soft_bins(_fbin(torch.atan2(dy, dx), nb), nb)).sum(-2)
    hist = (6.0 * hist + 4.0 * (hist.roll(1, -1) + hist.roll(-1, -1))
            + hist.roll(2, -1) + hist.roll(-2, -1)) / 16.0
    left, right = hist.roll(1, -1), hist.roll(-1, -1)
    is_peak = (hist > left) & (hist > right)
    denom = left - 2 * hist + right
    big = denom.abs() > 1e-12
    delta = torch.where(big, 0.5 * (left - right) / torch.where(big, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    bins = torch.arange(nb, dtype=dt, device=dev)
    theta = torch.remainder((bins + delta) / nb * 2.0 * math.pi, 2.0 * math.pi)
    return theta, is_peak


def _peak_distance(theta: torch.Tensor, peaks: torch.Tensor, is_peak: torch.Tensor):
    """[K, nb] circular distance from each theta to each peak (inf off peaks)."""
    d = torch.remainder(theta[:, None].to(peaks.dtype) - peaks + math.pi, 2.0 * math.pi) - math.pi
    return torch.where(is_peak, d.abs(), torch.full_like(d, math.inf))


def angle_gap(theta: torch.Tensor, peaks: torch.Tensor, is_peak: torch.Tensor) -> torch.Tensor:
    """[K] circular distance from each theta to its nearest peak."""
    return _peak_distance(theta, peaks, is_peak).amin(-1)


def nearest_peak(theta: torch.Tensor, peaks: torch.Tensor, is_peak: torch.Tensor) -> torch.Tensor:
    """[K] the peak nearest each theta (theta itself where none is)."""
    d = _peak_distance(theta, peaks, is_peak)
    i = d.argmin(-1, keepdim=True)
    found = torch.isfinite(d.gather(-1, i))[:, 0]
    return torch.where(found, peaks.gather(-1, i)[:, 0], theta.to(peaks.dtype))


def descriptors(gauss: torch.Tensor, r: Refined, theta: torch.Tensor,
                sift: dict, p: Prec) -> torch.Tensor:
    """[K, 128] SIFT descriptors at the keypoints, in the orientation
    theta: a G x G grid over 4 x 4 cells of 3 sigma, soft 8-bin angles,
    bilinear cell weights, a Gaussian window of sigma d/2, normalised,
    clipped at `desc_clip` and normalised again (cells major, bins minor)."""
    g, d, nb = sift["desc_grid"], sift["desc_width"], sift["desc_bins"]
    s = sift["scales_per_octave"]
    dev, dt = gauss.device, gauss.dtype
    c = (torch.arange(g, dtype=dt, device=dev) + 0.5) / g * d - d / 2.0
    vv, uu = torch.meshgrid(c, c, indexing="ij")
    vv, uu = vv.flatten(), uu.flatten()
    centres = torch.arange(d, dtype=dt, device=dev) - d / 2.0 + 0.5
    a = torch.clamp(1.0 - (c[:, None] - centres[None, :]).abs(), min=0.0)      # [g, d]
    gw = torch.exp(-(vv ** 2 + uu ** 2) / (0.5 * d * d))
    cell_w = sift["desc_scale_factor"] * sift["sigma0"] * torch.pow(2.0, r.so / s)
    th = theta.to(dt)
    ct, st = torch.cos(th)[:, None], torch.sin(th)[:, None]
    u = uu * cell_w[:, None]
    v = vv * cell_w[:, None]
    xs = r.xo[:, None] + u * ct - v * st
    ys = r.yo[:, None] + u * st + v * ct
    dx, dy, inb = sample_gradients(gauss, r.level, ys, xs)
    w = torch.sqrt(dx * dx + dy * dy) * gw * inb
    contrib = soft_bins(_fbin(th[:, None] - torch.atan2(dy, dx), nb), nb) * w[..., None]
    k = contrib.shape[0]
    cg = contrib.reshape(k, g, g, nb)                                         # [K, i, j, b]
    t = torch.einsum("kijb,jq->kiqb", _op(cg, p), _op(a, p))
    out = torch.einsum("kiqb,ip->kpqb", _op(t, p), _op(a, p)).reshape(k, d * d * nb)

    def norm(x):
        sq = (x * x).sum(-1, keepdim=True)
        return x / torch.sqrt(sq).clamp(min=1e-12)

    return norm(norm(out).clamp(max=sift["desc_clip"]))


# ---------------------------------------------------------------- matching

class Top2(NamedTuple):
    idx: torch.Tensor       # [N] int64
    ok: torch.Tensor        # [N] bool


def ratio_match(desc_a: torch.Tensor, valid_a: torch.Tensor, desc_b: torch.Tensor,
                valid_b: torch.Tensor, match: dict, p: Prec, block: int = 2048) -> Top2:
    """Lowe's ratio test over [N, 128] against [M, 128] unit descriptors:
    the best and second-best correlations, the L2 distances sqrt(2 - 2 s),
    best / second < ratio_thresh and best > min_score."""
    idx, ok = [], []
    b = desc_b.to(p.dtype)
    for lo in range(0, desc_a.shape[0], block):
        a = desc_a[lo:lo + block]
        s = mm(a, b.T, p)
        s = torch.where(valid_b[None, :], s, torch.full_like(s, -math.inf))
        top, i = torch.topk(s, 2, dim=-1)
        s1, s2 = top[:, 0], top[:, 1]
        d1 = torch.sqrt(torch.clamp(2.0 - 2.0 * s1.clamp(-1.0, 1.0), min=0.0))
        d2 = torch.sqrt(torch.clamp(2.0 - 2.0 * s2.clamp(-1.0, 1.0), min=1e-12))
        good = (valid_a[lo:lo + block] & torch.isfinite(s1) & torch.isfinite(s2)
                & (d1 / d2 < match["ratio_thresh"]) & (s1 > match["min_score"]))
        idx.append(i[:, 0])
        ok.append(good)
    return Top2(idx=torch.cat(idx), ok=torch.cat(ok))


def match_flips(prog_idx, prog_ok, ref: Top2, valid_a) -> int:
    """Rows of valid A whose best match or ratio-test outcome differs."""
    diff = (prog_ok.to(torch.bool) != ref.ok) | (prog_idx.long() != ref.idx)
    return int((diff & valid_a).sum())


# ---------------------------------------------------------------- geometry

def apply_homography(h, pts, p: Prec) -> torch.Tensor:
    """[N, 2] points mapped by a [3, 3] homography."""
    ph = torch.cat([pts.to(p.dtype), torch.ones_like(pts[:, :1], dtype=p.dtype)], -1)
    q = mm(ph, h.to(p.dtype).T, p)
    z = torch.where(q[:, 2:].abs() > 1e-12, q[:, 2:], torch.full_like(q[:, 2:], 1e-12))
    return q[:, :2] / z


def _normalise(pts, w):
    """Hartley's normalisation (weighted): zero mean, mean distance sqrt 2."""
    wsum = w.sum()
    c = (pts * w[:, None]).sum(0) / wsum
    s = math.sqrt(2.0) / ((torch.sqrt(((pts - c) ** 2).sum(-1)) * w).sum() / wsum)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    t = torch.stack([torch.stack([s, z, -s * c[0]]), torch.stack([z, s, -s * c[1]]),
                     torch.stack([z, z, o])])
    return (pts - c) * s, t


def fit_homography(pa, pb, w, p: Prec) -> torch.Tensor:
    """Weighted least-squares homography pa -> pb, Hartley-normalised, with
    h33 = 1 in the normalised frame (Hartley and Zisserman's normalised
    DLT)."""
    pa, pb, w = pa.to(p.dtype), pb.to(p.dtype), w.to(p.dtype)
    na, ta = _normalise(pa, w)
    nb, tb = _normalise(pb, w)
    xa, ya, xb, yb = na[:, 0], na[:, 1], nb[:, 0], nb[:, 1]
    z, o = torch.zeros_like(xa), torch.ones_like(xa)
    a = torch.cat([torch.stack([xa, ya, o, z, z, z, -xb * xa, -xb * ya], -1),
                   torch.stack([z, z, z, xa, ya, o, -yb * xa, -yb * ya], -1)])
    b = torch.cat([xb, yb])
    ww = torch.cat([w, w])[:, None]
    h8 = torch.linalg.solve(mm((a * ww).T, a, p), mm((a * ww).T, b[:, None], p))[:, 0]
    hn = torch.cat([h8, torch.ones_like(h8[:1])]).reshape(3, 3)
    h = torch.linalg.inv(tb) @ hn @ ta
    return h / h[2, 2]


def fit_rigid(pa, pb, w, p: Prec):
    """Weighted least-squares rotation and translation with R pa + t ~ pb
    (Kabsch: the SVD of the weighted cross-covariance)."""
    pa, pb, w = pa.to(p.dtype), pb.to(p.dtype), w.to(p.dtype)
    wsum = w.sum()
    ca = (pa * w[:, None]).sum(0) / wsum
    cb = (pb * w[:, None]).sum(0) / wsum
    cov = mm(((pa - ca) * w[:, None]).T, pb - cb, p)             # sum w a b^T
    u, _, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    r = vt.T @ torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d])) @ u.T
    return r, cb - r @ ca


def depth_at(depth: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Depth at the nearest pixel (rounding half to even)."""
    h, w = depth.shape
    xi = torch.round(xs).long().clamp(0, w - 1)
    yi = torch.round(ys).long().clamp(0, h - 1)
    return depth[yi, xi]


def backproject(xs, ys, z, intr) -> torch.Tensor:
    fx, fy, cx, cy = (float(v) for v in intr)
    return torch.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], -1)


# ---------------------------------------------------------------- window BA

# the SLAM loop's window BA: reprojection residuals of the newest
# keyframe's points under a Huber cost of 4 px, a 25 px association gate,
# the window's two oldest poses fixed (the gauge)
WINDOW_HUBER_PX = 4.0
WINDOW_GATE_PX = 25.0
WINDOW_FIXED = 2

class WindowObs(NamedTuple):
    """A keyframe window's observations of the newest keyframe's points."""

    uv: torch.Tensor        # [W, N, 2] observed pixels
    w: torch.Tensor         # [W, N] 1 where observed, else 0
    points: torch.Tensor    # [N, 3] the landmarks' starting world positions


def _project(pc: torch.Tensor, intr) -> torch.Tensor:
    fx, fy, cx, cy = (float(v) for v in intr)
    return torch.stack([fx * pc[..., 0] / pc[..., 2] + cx, fy * pc[..., 1] / pc[..., 2] + cy], -1)


def window_observations(kf_desc, kf_valid, kf_pts, pose_r, pose_t, intr, match: dict,
                        gate_px: float = 25.0) -> WindowObs:
    """Local BA's data association, newest-anchored, at the window's poses
    before the solve: each valid point of the newest keyframe is a landmark
    (its backprojection in world coordinates), observed in every window
    keyframe (itself included) whose ratio-test match of it lands within
    `gate_px` of its projection, in front of the camera."""
    a = kf_valid.shape[0] - 1
    r, t = pose_r.double(), pose_t.double()
    pts = kf_pts.double()
    valid_a = kf_valid[a] & (pts[a, :, 2] > 1e-6)
    points = (pts[a] - t[a]) @ r[a]                                  # R^T (x - t)
    uv, w = [], []
    for k in range(kf_valid.shape[0]):
        m = ratio_match(kf_desc[a], valid_a, kf_desc[k], kf_valid[k], match, F64)
        pk = pts[k][m.idx]
        pc = points @ r[k].T + t[k]
        ok = m.ok & valid_a & (pk[:, 2] > 1e-6) & (pc[:, 2] > 1e-2)
        seen = _project(torch.where(ok[:, None], pk, torch.ones_like(pk)), intr)
        pred = _project(torch.where(ok[:, None], pc, torch.ones_like(pc)), intr)
        ok = ok & (((seen - pred) ** 2).sum(-1) < gate_px ** 2)
        uv.append(seen)
        w.append(ok.double())
    return WindowObs(uv=torch.stack(uv), w=torch.stack(w), points=points)


def _huber(sq: torch.Tensor, delta: float) -> torch.Tensor:
    """The robust cost of a squared residual norm: sq inside delta, then
    linear in the norm (twice the textbook Huber, as the solve sums it)."""
    nrm = torch.sqrt(sq.clamp(min=1e-30))
    return torch.where(nrm <= delta, sq, 2.0 * delta * nrm - delta * delta)


def _rotation(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] rotation vectors -> [..., 3, 3]."""
    th = phi.norm(dim=-1, keepdim=True)[..., None]
    k = phi / phi.norm(dim=-1, keepdim=True).clamp(min=1e-300)
    z = torch.zeros_like(k[..., 0])
    kx = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                      torch.stack([k[..., 2], z, -k[..., 0]], -1),
                      torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand_as(kx)
    return eye + torch.sin(th) * kx + (1.0 - torch.cos(th)) * (kx @ kx)


def _ba_cost(r, t, x, obs: WindowObs, intr, delta: float) -> torch.Tensor:
    """Per-landmark cost [N]: half the weighted robust squared residuals."""
    pc = torch.einsum("wij,nj->wni", r, x) + t[:, None, :]
    ok = (obs.w > 0) & (pc[..., 2] > 1e-9)
    pc = torch.where(ok[..., None], pc, torch.ones_like(pc))
    sq = ((_project(pc, intr) - obs.uv) ** 2).sum(-1)
    return 0.5 * (obs.w * _huber(sq, delta)).sum(0)


def bundle_adjust(r, t, obs: WindowObs, intr, delta: float, free: torch.Tensor,
                  iters: int = 100):
    """Levenberg-Marquardt to convergence in float64 over the landmarks and
    the cameras where `free` [W] is true (the others, the gauge, stay),
    IRLS for the robust cost, the cameras' reduced system solved densely.
    With no camera free each landmark takes its own steps.  Returns the
    cameras and the per-landmark cost [N] at the optimum."""
    fx, fy = float(intr[0]), float(intr[1])
    r, t, x = r.double(), t.double(), obs.points.clone()
    nw = r.shape[0]
    cost = _ba_cost(r, t, x, obs, intr, delta)
    lam = torch.full_like(cost, 1e-4) if not bool(free.any()) else cost.new_tensor(1e-4)
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    eye6 = torch.eye(6, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        pc = torch.einsum("wij,nj->wni", r, x) + t[:, None, :]
        ok = (obs.w > 0) & (pc[..., 2] > 1e-9)
        pc = torch.where(ok[..., None], pc, torch.ones_like(pc))
        res = _project(pc, intr) - obs.uv                              # [W, N, 2]
        nrm = res.norm(dim=-1).clamp(min=1e-30)
        om = obs.w * ok * torch.clamp(delta / nrm, max=1.0)            # IRLS weights
        iz = 1.0 / pc[..., 2]
        zero = torch.zeros_like(iz)
        dproj = torch.stack([torch.stack([fx * iz, zero, -fx * pc[..., 0] * iz * iz], -1),
                             torch.stack([zero, fy * iz, -fy * pc[..., 1] * iz * iz], -1)], -2)
        jp = dproj @ r[:, None]                                        # [W, N, 2, 3]
        hat = torch.zeros(*pc.shape, 3, dtype=x.dtype, device=x.device)
        hat[..., 0, 1], hat[..., 0, 2] = -pc[..., 2], pc[..., 1]
        hat[..., 1, 0], hat[..., 1, 2] = pc[..., 2], -pc[..., 0]
        hat[..., 2, 0], hat[..., 2, 1] = -pc[..., 1], pc[..., 0]
        jc = dproj @ torch.cat([eye3.expand_as(hat), -hat], -1)        # [W, N, 2, 6]
        wr = om[..., None] * res
        v = torch.einsum("wn,wnai,wnaj->nij", om, jp, jp)
        bp = torch.einsum("wnai,wna->ni", jp, wr)
        lam_p = lam[:, None, None] if lam.dim() else lam
        vinv = torch.linalg.inv(v + lam_p * (torch.diagonal(v, dim1=-2, dim2=-1)[..., None]
                                             * eye3 + 1e-9 * eye3))
        dc = torch.zeros(nw, 6, dtype=x.dtype, device=x.device)
        if bool(free.any()):
            u = torch.einsum("wn,wnai,wnaj->wij", om, jc, jc)
            bc = torch.einsum("wnai,wna->wi", jc, wr)
            wb = torch.einsum("wn,wnai,wnaj->wnij", om, jc, jp)        # [W, N, 6, 3]
            s = -torch.einsum("knab,nbc,mndc->kamd", wb, vinv, wb)
            ud = u + lam * (torch.diagonal(u, dim1=-2, dim2=-1)[..., None] * eye6 + 1e-9 * eye6)
            for k in range(nw):
                s[k, :, k, :] += ud[k]
            g = bc - torch.einsum("knab,nbc,nc->ka", wb, vinv, bp)
            f = torch.nonzero(free)[:, 0]
            sf = s[f][:, :, f].reshape(6 * len(f), 6 * len(f))
            dc[f] = torch.linalg.solve(sf, -g[f].reshape(-1)).reshape(-1, 6)
            dp = -(vinv @ (bp + torch.einsum("wnab,wa->nb", wb, dc))[..., None])[..., 0]
        else:
            dp = -(vinv @ bp[..., None])[..., 0]
        dr = _rotation(dc[:, 3:])
        r2, t2 = dr @ r, (dr @ t[..., None])[..., 0] + dc[:, :3]
        c2 = _ba_cost(r2, t2, x + dp, obs, intr, delta)
        if lam.dim():                   # landmark by landmark
            acc = torch.isfinite(c2) & (c2 < cost)
            drop = float(torch.where(acc, cost - c2, torch.zeros_like(cost)).sum())
            x = torch.where(acc[:, None], x + dp, x)
            cost = torch.where(acc, c2, cost)
            lam = torch.where(acc, lam * 0.3, lam * 5.0).clamp(1e-12, 1e12)
            if drop <= 1e-15 * float(cost.sum()):
                break
            continue
        if bool(torch.isfinite(c2.sum())) and float(c2.sum()) < float(cost.sum()):
            step = float(cost.sum() - c2.sum()) / float(cost.sum())
            r, t, x, cost, lam = r2, t2, x + dp, c2, (lam * 0.3).clamp(min=1e-12)
            if step < 1e-13:
                break
        else:
            lam = lam * 5.0
            if float(lam) > 1e12:
                break
    return r, t, cost


def ba_left(before_r, before_t, after_r, after_t, obs: WindowObs, intr, delta: float,
            fixed: int) -> tuple[float, float]:
    """The share of the window's reducible cost that a solve left: the
    cost at the poses after it over the cost at the poses before, each
    less the cost at the float64 optimum, with the landmarks at their
    float64 optimum for each set of poses (a solve that leaves its state
    unchanged reads 1).  Also the reducible cost itself, over the optimum's."""
    none = torch.zeros(before_r.shape[0], dtype=torch.bool, device=before_r.device)
    free = torch.arange(before_r.shape[0], device=before_r.device) >= fixed
    _, _, c_before = bundle_adjust(before_r, before_t, obs, intr, delta, none)
    _, _, c_after = bundle_adjust(after_r, after_t, obs, intr, delta, none)
    r_opt, t_opt, _ = bundle_adjust(before_r, before_t, obs, intr, delta, free)
    _, _, c_opt = bundle_adjust(r_opt, t_opt, obs, intr, delta, none)
    best = float(c_opt.sum())
    gain = float(c_before.sum()) - best
    return (float(c_after.sum()) - best) / gain, gain / max(best, 1e-300)


# ---------------------------------------------------------------- keyframes

def needs_keyframe(row, last, slam: dict):
    """SlamConfig's keyframe gates on one frame's packed tracking row
    [inliers, ok, kpts, matches | R 9 | t 3 | twist 6] (T_frame<-reference):
    a keyframe when the frame is tracked (ok and at least
    `track_min_inliers`) and has fewer than `kf_min_inliers` inliers or
    moved more than `kf_max_translation` metres or `kf_max_rotation`
    radians.  In a chunk the motion is measured from the last keyframe
    inserted in it (`last`, its (R, t) against the same reference) where
    there is one.  Returns (decision, the chunk's last insert after this
    frame); the decision is None for a frame that tracking lost."""
    import numpy as np

    inl = int(row[0])
    if not (row[1] != 0 and inl >= slam["track_min_inliers"]):
        return None, last
    rel_r, rel_t = row[4:13].reshape(3, 3), row[13:16]
    if last is None:
        trans, rot = float(np.linalg.norm(row[16:19])), float(np.linalg.norm(row[19:22]))
    else:
        r2 = rel_r @ last[0].T
        trans = float(np.linalg.norm(rel_t - r2 @ last[1]))
        rot = float(np.arccos(np.clip((np.trace(r2) - 1.0) / 2.0, -1.0, 1.0)))
    need = (inl < slam["kf_min_inliers"] or trans > slam["kf_max_translation"]
            or rot > slam["kf_max_rotation"])
    return need, ((rel_r, rel_t) if need else last)

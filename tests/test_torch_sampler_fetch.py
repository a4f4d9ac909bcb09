"""K1's loads, on the CPU.

K1 (`cusift_tpu_torch/csrc/sampler.cu:sample_grad_12`) loads each of the
12 distinct floats that a sample's corners and their central differences
read once and unconditionally, where `sample_grad` (K4, K5, K6) makes 16
loads under the border tests.  The kernel runs only on the card
(`tests/test_torch_cuda.py`).  Here numpy replays the 12 addresses and
checks that they lie in the plane and cover every read of `sample_grad`
that its border tests keep; that sampling from them gives `sample_grad`'s
bits (both in numpy f32) and the JAX reference's values (atol 1e-5 on
in-image samples); and that `chip_smoke.py`'s byte count for K1's bound is
the number of distinct pixels those loads read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cusift_tpu.ops.gaussian import image_gradients
from cusift_tpu.ops.sampling import bilinear_sample_pair

F32 = np.float32


def _corners(ys, xs, h, w):
    """The kernels' clip: corners (y0, x0) [N, S] and fractions, in f32."""
    y = np.fmin(np.fmax(ys, F32(0)), F32(h - 1.000001))    # fmax drops NaN
    x = np.fmin(np.fmax(xs, F32(0)), F32(w - 1.000001))
    y0 = np.minimum(np.floor(y).astype(np.int64), h - 2)
    x0 = np.minimum(np.floor(x).astype(np.int64), w - 2)
    return y0, x0, (y - y0.astype(F32)).astype(F32), (x - x0.astype(F32)).astype(F32)


def _reads_16(y0, x0, h, w):
    """Each (row, col) sample_grad reads, [N, S, 16], and whether its
    border test keeps it."""
    rows, cols, kept = [], [], []
    for dr in (0, 1):
        for dc in (0, 1):
            r, c = y0 + dr, x0 + dc
            okx = (c > 0) & (c < w - 1)
            oky = (r > 0) & (r < h - 1)
            for rr, cc, ok in ((r, c - 1, okx), (r, c + 1, okx), (r - 1, c, oky),
                               (r + 1, c, oky)):
                rows.append(rr)
                cols.append(cc)
                kept.append(ok)
    return np.stack(rows, -1), np.stack(cols, -1), np.stack(kept, -1)


def _loads_12(y0, x0, h, w):
    """sample_grad_12's addresses, a dict of (row, col) [N, S] by name:
    u0 u1 (row y0 - 1), a_ a0 a1 a2 (row y0), b_ b0 b1 b2 (row y0 + 1),
    d0 d1 (row y0 + 2); the rows above and below and the columns left and
    right fall back to the corner's own at the border."""
    up = np.where(y0 > 0, y0 - 1, y0)
    dn = np.where(y0 + 2 < h, y0 + 2, y0 + 1)
    cl = np.where(x0 > 0, x0 - 1, x0)
    cr = np.where(x0 + 2 < w, x0 + 2, x0 + 1)
    loads = {"u0": (up, x0), "u1": (up, x0 + 1), "d0": (dn, x0), "d1": (dn, x0 + 1)}
    for name, r in (("a", y0), ("b", y0 + 1)):
        for tag, c in (("_", cl), ("0", x0), ("1", x0 + 1), ("2", cr)):
            loads[name + tag] = (r, c)
    return loads


def _case(name, rng):
    """(h, w, ys [N, S], xs [N, S]) for one kind of slot."""
    n, s = 24, 144
    h, w = {"h2": (2, 40), "w2": (36, 2), "odd_width": (50, 61)}.get(name, (60, 84))
    cy = rng.uniform(0, h, (n, 1))
    cx = rng.uniform(0, w, (n, 1))
    ys = cy + rng.uniform(-8, 8, (n, s))
    xs = cx + rng.uniform(-8, 8, (n, s))
    if name == "border":
        ys[:8] = rng.choice([0.0, h - 1.0, h - 1.5], (8, s))
        xs[8:16] = rng.choice([0.0, w - 1.0, 0.5, w - 2.0], (8, s))
        ys[16:] = np.where(rng.random((8, s)) < 0.5, 0.0, h - 1.0)
        xs[16:] = np.where(rng.random((8, s)) < 0.5, 0.0, w - 1.0)
    elif name == "outside":
        ys = ys + rng.choice([-40.0, 0.0, h + 40.0], (n, 1))
        xs = xs + rng.choice([-40.0, 0.0, w + 40.0], (n, 1))
    elif name == "nan_inf":
        ys[:6, ::3] = np.nan
        xs[6:12, ::5] = np.nan
        ys[12:18, ::7] = np.inf
        xs[18:, ::2] = -np.inf
    return h, w, ys.astype(F32), xs.astype(F32)


CASES = ["random", "border", "outside", "nan_inf", "h2", "w2", "odd_width"]


@pytest.mark.parametrize("name", CASES)
def test_loads_cover_every_kept_read(name):
    """The 12 loads lie in the plane, and every read of sample_grad that
    its border tests keep is one of them."""
    h, w, ys, xs = _case(name, np.random.default_rng(CASES.index(name)))
    y0, x0, _, _ = _corners(ys, xs, h, w)
    loads = _loads_12(y0, x0, h, w)
    for r, c in loads.values():
        assert ((r >= 0) & (r < h) & (c >= 0) & (c < w)).all()
    rr, cc, kept = _reads_16(y0, x0, h, w)
    at = lambda r, c: r * w + c
    got = np.stack([at(r, c) for r, c in loads.values()], -1)          # [N, S, 12]
    want = at(rr, cc)                                                   # [N, S, 16]
    hit = (want[..., :, None] == got[..., None, :]).any(-1)
    assert hit[kept].all()


def _interp(gx, gy, fy, fx):
    ux, uy = F32(1) - fx, F32(1) - fy
    dx = (gx[0] * ux + gx[1] * fx) * uy + (gx[2] * ux + gx[3] * fx) * fy
    dy = (gy[0] * ux + gy[1] * fx) * uy + (gy[2] * ux + gy[3] * fx) * fy
    return dx.astype(F32), dy.astype(F32)


def _sample_16(plane, y0, x0, fy, fx):
    """sample_grad in numpy f32: reads under the border tests."""
    h, w = plane.shape
    g = lambda r, c: plane[np.clip(r, 0, h - 1), np.clip(c, 0, w - 1)]

    def gx(r, c):
        ok = (c > 0) & (c < w - 1)
        return np.where(ok, F32(0.5) * (g(r, c + 1) - g(r, c - 1)), F32(0))

    def gy(r, c):
        ok = (r > 0) & (r < h - 1)
        return np.where(ok, F32(0.5) * (g(r + 1, c) - g(r - 1, c)), F32(0))

    return _interp([gx(y0, x0), gx(y0, x0 + 1), gx(y0 + 1, x0), gx(y0 + 1, x0 + 1)],
                   [gy(y0, x0), gy(y0, x0 + 1), gy(y0 + 1, x0), gy(y0 + 1, x0 + 1)], fy, fx)


def _sample_12(plane, y0, x0, fy, fx):
    """sample_grad_12 in numpy f32: the 12 loads, then the border tests."""
    h, w = plane.shape
    v = {k: plane[r, c] for k, (r, c) in _loads_12(y0, x0, h, w).items()}
    cx0 = (x0 > 0) & (x0 < w - 1)
    cx1 = x0 + 1 < w - 1
    cy0 = (y0 > 0) & (y0 < h - 1)
    cy1 = y0 + 1 < h - 1
    d = lambda ok, a, b: np.where(ok, F32(0.5) * (v[a] - v[b]), F32(0))
    return _interp([d(cx0, "a1", "a_"), d(cx1, "a2", "a0"), d(cx0, "b1", "b_"),
                    d(cx1, "b2", "b0")],
                   [d(cy0, "b0", "u0"), d(cy0, "b1", "u1"), d(cy1, "d0", "a0"),
                    d(cy1, "d1", "a1")], fy, fx)


@pytest.mark.parametrize("name", CASES)
def test_loads_sample_as_sample_grad(name):
    """Sampling from the 12 loads gives sample_grad's bits, in numpy f32,
    and the JAX reference's values."""
    rng = np.random.default_rng(100 + CASES.index(name))
    h, w, ys, xs = _case(name, rng)
    n = ys.shape[0]
    gauss = rng.normal(size=(3, h, w)).astype(F32)
    lvl = rng.integers(0, 3, n).astype(np.int32)
    y0, x0, fy, fx = _corners(ys, xs, h, w)
    dx = np.empty_like(ys)
    dy = np.empty_like(ys)
    for i in range(n):
        ref = _sample_16(gauss[lvl[i]], y0[i], x0[i], fy[i], fx[i])
        got = _sample_12(gauss[lvl[i]], y0[i], x0[i], fy[i], fx[i])
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        dx[i], dy[i] = got
    # the reference gets -1 (outside, as NaN and inf are) for a non-finite point
    finite = np.isfinite(ys) & np.isfinite(xs)
    jys, jxs = (jnp.asarray(np.where(finite, a, F32(-1))) for a in (ys, xs))
    gdx, gdy = image_gradients(jnp.asarray(gauss))
    rdx, rdy, rinb = (np.asarray(o) for o in bilinear_sample_pair(
        jnp.stack([gdx, gdy], -1), jnp.asarray(lvl), jys, jxs))
    np.testing.assert_allclose(dx[rinb], rdx[rinb], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dy[rinb], rdy[rinb], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_bound_counts_the_pixels_loaded(name):
    """chip_smoke.sample_bytes, the level bytes of K1's and K6's bound, is
    4 bytes for each distinct (level, row, col) the 12 loads read, which
    is at least each kept read of sample_grad and at most the stack."""
    rng = np.random.default_rng(200 + CASES.index(name))
    h, w, ys, xs = _case(name, rng)
    n = ys.shape[0]
    L = 3
    lvl = rng.integers(-1, L + 1, n).astype(np.int32)     # clipped to [0, L - 1]
    y0, x0, _, _ = _corners(ys, xs, h, w)
    lv = np.clip(lvl, 0, L - 1)[:, None]
    loaded = {(l, r, c) for rows, cols in _loads_12(y0, x0, h, w).values()
              for l, r, c in zip(np.broadcast_to(lv, rows.shape).ravel(), rows.ravel(),
                                 cols.ravel())}
    rr, cc, kept = _reads_16(y0, x0, h, w)
    kept_reads = {(l, r, c) for l, r, c in
                  zip(np.broadcast_to(lv[..., None], rr.shape)[kept], rr[kept], cc[kept])}
    assert kept_reads <= loaded and len(loaded) <= L * h * w
    gauss = torch.zeros((L, h, w))
    got = chip_smoke.sample_bytes(gauss, torch.from_numpy(lvl), torch.from_numpy(ys),
                                  torch.from_numpy(xs))
    assert got == 4 * len(loaded)

"""K6's separable set-up and its 12 loads, on the CPU.

K6 (`cusift_tpu_torch/csrc/sampler.cu:sample_grad_sep_kernel`) samples the
point (ys_rows[n, r], xs_cols[n, c]) from the `Axis` of its row (clip,
corner, fraction, border steps, in-flag) and of its column, which depend
on that row or column alone, then makes `grad_12`'s 12 loads.  The kernel
runs only on the card (`tests/test_torch_cuda.py`).  Here numpy replays
it: each slot's GR row and GC column set-ups computed once from the rows
and columns alone (the level folded into the row's offset), then the
addresses and values of every sample.  It checks that the addresses lie
in the slot's level plane and cover every read of `sample_grad` (K4 and
K5) that its border tests keep; that the values are
`sample_grad`'s bits at the expanded point (both in numpy f32); that inb is
row-in & col-in of the expanded point; and that they agree with the JAX
reference's XLA gather on the expanded grid (atol 1e-5 on in-image
samples, inb equal) and with K6's plain version.  Cases: random rows and
columns, the orientation grid, rows and columns on the borders, grids
wholly outside the image, NaN and inf rows and columns, GR != GC, N = 1,
h = 2 and w = 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cusift_tpu.ops.gaussian import image_gradients
from cusift_tpu.ops.sampling import bilinear_sample_pair
from cusift_tpu_torch.kernels import sampler as k
from test_torch_sampler_fetch import _corners, _reads_16, _sample_16

F32 = np.float32


def _axis(v, n):
    """The kernel's Axis of each row (n = h) or column (n = w) value, f32:
    (i0, lo, hi, f, in)."""
    inside = (v >= 0) & (v <= n - 1)
    c = np.fmin(np.fmax(v, F32(0)), F32(n - 1.000001))          # fmax drops NaN
    i0 = np.minimum(np.floor(c).astype(np.int64), n - 2)
    f = (c - i0.astype(F32)).astype(F32)
    return i0, np.where(i0 > 0, -1, 0), np.where(i0 + 2 < n, 2, 1), f, inside


def _setups(lvl, ys_rows, xs_cols, L, h, w):
    """The set-up of each (slot, row) and (slot, column): (offset of the
    corner row in the stack, lo, hi, in, f) and (x0, lo, hi, in, f)."""
    y0, ylo, yhi, fy, yin = _axis(ys_rows, h)
    x0, xlo, xhi, fx, xin = _axis(xs_cols, w)
    l = np.clip(lvl, 0, L - 1)[:, None]
    return (l * h * w + y0 * w, ylo, yhi, yin, fy), (x0, xlo, xhi, xin, fx)


def _samples(rows, cols, w):
    """The 12 addresses of each sample (n, r * GC + c), a dict of
    flat stack indices [N, GR * GC] by name, beside (fy, fx) and the steps
    broadcast to the samples.  Rows r0 and r1 = r0 + w at the corner
    columns; up = r0 + ylo * w and dn = r0 + yhi * w; left x0 + xlo and
    right x0 + xhi."""
    n, gr = rows[0].shape
    gc = cols[0].shape[1]
    grid = lambda a, axis: np.broadcast_to(
        a[:, :, None] if axis == 0 else a[:, None, :], (n, gr, gc)).reshape(n, -1)
    off, ylo, yhi, yin, fy = (grid(a, 0) for a in rows)
    x0, xlo, xhi, xin, fx = (grid(a, 1) for a in cols)
    r0 = off + x0
    loads = {"u0": r0 + ylo * w, "u1": r0 + ylo * w + 1, "d0": r0 + yhi * w,
             "d1": r0 + yhi * w + 1}
    for name, base in (("a", r0), ("b", r0 + w)):
        for tag, step in (("_", xlo), ("0", 0), ("1", 1), ("2", xhi)):
            loads[name + tag] = base + step
    return loads, (ylo, yhi, xlo, xhi), (fy, fx), yin & xin


def _grad_12(stack, loads, steps, fracs):
    """grad_12's values in numpy f32 from the 12 loads."""
    v = {name: stack[idx] for name, idx in loads.items()}
    ylo, yhi, xlo, xhi = steps
    d = lambda ok, a, b: np.where(ok, F32(0.5) * (v[a] - v[b]), F32(0))
    cx0, cx1, cy0, cy1 = xlo != 0, xhi == 2, ylo != 0, yhi == 2
    gx = [d(cx0, "a1", "a_"), d(cx1, "a2", "a0"), d(cx0, "b1", "b_"), d(cx1, "b2", "b0")]
    gy = [d(cy0, "b0", "u0"), d(cy0, "b1", "u1"), d(cy1, "d0", "a0"), d(cy1, "d1", "a1")]
    fy, fx = fracs
    ux, uy = F32(1) - fx, F32(1) - fy
    dx = (gx[0] * ux + gx[1] * fx) * uy + (gx[2] * ux + gx[3] * fx) * fy
    dy = (gy[0] * ux + gy[1] * fx) * uy + (gy[2] * ux + gy[3] * fx) * fy
    return dx.astype(F32), dy.astype(F32)


def _case(name, rng):
    """(L, h, w, lvl [N], ys_rows [N, GR], xs_cols [N, GC]) of one case."""
    L, n, gr, gc = 3, 24, 12, 12
    h, w = {"h2": (2, 40), "w2": (36, 2)}.get(name, (60, 84))
    if name == "gr_ne_gc":
        gr, gc = 5, 9
    if name == "n1":
        n = 1
    lvl = rng.integers(-1, L + 1, n).astype(np.int32)
    if name == "orientation":
        lvl_t, ys_rows, xs_cols = chip_smoke.orientation_rows(rng, "cpu", n, L, h, w)
        return L, h, w, lvl_t.numpy(), ys_rows.numpy(), xs_cols.numpy()
    ys_rows = rng.uniform(0, h, (n, 1)) + rng.uniform(-8, 8, (n, gr))
    xs_cols = rng.uniform(0, w, (n, 1)) + rng.uniform(-8, 8, (n, gc))
    if name == "border":
        ys_rows[:12, ::2] = rng.choice([0.0, h - 1.0, h - 1.5, 0.5], (12, gr // 2))
        xs_cols[6:18, 1::2] = rng.choice([0.0, w - 1.0, w - 2.0, 0.5], (12, gc // 2))
    elif name == "outside":
        ys_rows[:8] -= h + 20.0
        xs_cols[8:16] += w + 20.0
        ys_rows[16:] += rng.choice([-h - 20.0, h + 20.0], (n - 16, 1))
        xs_cols[16:] += rng.choice([-w - 20.0, w + 20.0], (n - 16, 1))
    elif name == "nan_inf":
        ys_rows[:4, ::3] = np.nan
        ys_rows[4] = np.nan
        xs_cols[5:9, ::4] = np.nan
        xs_cols[9:13, ::5] = np.inf
        ys_rows[13:17, ::2] = -np.inf
    return L, h, w, lvl, ys_rows.astype(F32), xs_cols.astype(F32)


CASES = ["random", "orientation", "border", "outside", "nan_inf", "gr_ne_gc", "n1", "h2",
         "w2"]


def _expanded(ys_rows, xs_cols):
    ys, xs = chip_smoke.expand_grid(torch.from_numpy(ys_rows), torch.from_numpy(xs_cols))
    return ys.numpy(), xs.numpy()


@pytest.mark.parametrize("name", CASES)
def test_setups_address_the_kept_reads(name):
    """Every sample's 12 addresses, built from its row's and column's
    set-ups, lie in its slot's level plane and hold every read of
    sample_grad at the expanded point that its border tests keep."""
    L, h, w, lvl, ys_rows, xs_cols = _case(name, np.random.default_rng(CASES.index(name)))
    loads, _, _, _ = _samples(*_setups(lvl, ys_rows, xs_cols, L, h, w), w)
    plane = (np.clip(lvl, 0, L - 1) * h * w)[:, None]
    got = np.stack(list(loads.values()), -1)                            # [N, S, 12]
    assert ((got >= plane[..., None]) & (got < plane[..., None] + h * w)).all()
    ys, xs = _expanded(ys_rows, xs_cols)
    y0, x0, _, _ = _corners(ys, xs, h, w)
    rr, cc, kept = _reads_16(y0, x0, h, w)
    want = plane[..., None] + rr * w + cc                               # [N, S, 16]
    hit = (want[..., :, None] == got[..., None, :]).any(-1)
    assert hit[kept].all()


@pytest.mark.parametrize("name", CASES)
def test_setups_sample_as_sample_grad(name):
    """Sampling from the set-ups and the 12 loads gives sample_grad's bits
    at each expanded point (numpy f32) and inb = row-in & col-in; both agree
    with the JAX reference's XLA gather and with K6's plain version."""
    rng = np.random.default_rng(100 + CASES.index(name))
    L, h, w, lvl, ys_rows, xs_cols = _case(name, rng)
    gauss = rng.normal(size=(L, h, w)).astype(F32)
    loads, steps, fracs, inb = _samples(*_setups(lvl, ys_rows, xs_cols, L, h, w), w)
    dx, dy = _grad_12(gauss.reshape(-1), loads, steps, fracs)
    ys, xs = _expanded(ys_rows, xs_cols)
    y0, x0, fy, fx = _corners(ys, xs, h, w)
    li = np.clip(lvl, 0, L - 1)
    for i in range(ys.shape[0]):
        ref = _sample_16(gauss[li[i]], y0[i], x0[i], fy[i], fx[i])
        for a, b in zip((dx[i], dy[i]), ref):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(inb, (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1))
    # the reference gets -1 (outside, as NaN and inf are) for a non-finite point
    finite = np.isfinite(ys) & np.isfinite(xs)
    jys, jxs = (jnp.asarray(np.where(finite, a, F32(-1))) for a in (ys, xs))
    gdx, gdy = image_gradients(jnp.asarray(gauss))
    rdx, rdy, rinb = (np.asarray(o) for o in bilinear_sample_pair(
        jnp.stack([gdx, gdy], -1), jnp.asarray(lvl), jys, jxs))
    np.testing.assert_array_equal(inb, rinb)
    np.testing.assert_allclose(dx[rinb], rdx[rinb], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dy[rinb], rdy[rinb], atol=1e-5, rtol=0)
    pdx, pdy, pinb = (o.numpy() for o in k.sample_grad_patches_sep_plain(
        *(torch.from_numpy(a) for a in (gauss, lvl, ys_rows, xs_cols))))
    np.testing.assert_array_equal(inb, pinb)
    np.testing.assert_allclose(dx[inb], pdx[inb], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dy[inb], pdy[inb], atol=1e-5, rtol=0)


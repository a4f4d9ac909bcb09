"""Kernels K4, K5 and K6 (cusift_tpu_torch/kernels/sampler.py) against the
JAX package.

On the CPU each wrapper takes its plain torch version.  Each is held
against its JAX Pallas kernel in interpret mode at the bound of the JAX
test (tests/test_pallas_sampler.py), which allows for the kernels' bf16
dots: K4 2e-2 of the largest bin, K5 cosine > 0.9995, K6 median relative
error < 8e-3.  Each is also held against the JAX XLA formula it replaces,
in float32, at rtol 1e-4 / atol 1e-5 (K6: atol 1e-5, inb equal).
"""

import jax.numpy as jnp
import numpy as np
import torch

from cusift_tpu.ops.gaussian import image_gradients
from cusift_tpu.ops.pallas import sampler as jax_pallas
from cusift_tpu.ops.sampling import bilinear_sample_pair
from cusift_tpu_torch.kernels import sampler as k

torch.set_num_threads(2)


def _xla_reference(gauss, lvl, ys, xs):
    gdx, gdy = image_gradients(jnp.asarray(gauss))
    out = bilinear_sample_pair(jnp.stack([gdx, gdy], -1), jnp.asarray(lvl),
                               jnp.asarray(ys), jnp.asarray(xs))
    return tuple(np.asarray(o) for o in out)


def _hist_desc_setup(seed=11, L=3, H=96, W=160, N=16, S=64):
    """tests/test_pallas_sampler.py's inputs of the K4/K5 tests (numpy)."""
    rng2 = np.random.default_rng(seed)
    gauss = rng2.normal(size=(L, H, W)).astype(np.float32)
    lvl = rng2.integers(0, L, N).astype(np.int32)
    cy = rng2.uniform(8, H - 8, N).astype(np.float32)
    cx = rng2.uniform(8, W - 8, N).astype(np.float32)
    off = rng2.uniform(-10, 10, (N, S)).astype(np.float32)
    ys = cy[:, None] + off
    xs = cx[:, None] + off[:, ::-1]
    wv = rng2.uniform(0.2, 1.0, (N, S)).astype(np.float32)
    return gauss, lvl, ys, xs, wv


def _jax_soft_bins(ang, nb):
    # the binning of cusift_tpu/ops/orientation.py:97-101 and describe.py:150-154
    fbin = (ang / (2.0 * jnp.pi) * nb) % nb
    dist = jnp.abs(fbin[..., None] - jnp.arange(nb, dtype=jnp.float32))
    dist = jnp.minimum(dist, nb - dist)
    return jnp.maximum(0.0, 1.0 - dist)


def _jax_xla_hist(gauss, lvl, ys, xs, wv, nb):
    """The reference's XLA orientation formula (ops/orientation.py:87-103)."""
    dx, dy, inb = (jnp.asarray(a) for a in _xla_reference(gauss, lvl, ys, xs))
    w = jnp.sqrt(dx * dx + dy * dy) * jnp.asarray(wv) * inb
    return np.asarray(jnp.einsum("ks,ksb->kb", w, _jax_soft_bins(jnp.arctan2(dy, dx), nb)))


def _jax_xla_desc_raw(gauss, lvl, ys, xs, theta, wv, wsp, nb):
    """The reference's XLA descriptor formula (ops/describe.py:137-159),
    bins major like K5: [N, nb, cells]."""
    dx, dy, inb = (jnp.asarray(a) for a in _xla_reference(gauss, lvl, ys, xs))
    w = jnp.sqrt(dx * dx + dy * dy) * jnp.asarray(wv) * inb
    ang = jnp.asarray(theta)[:, None] - jnp.arctan2(dy, dx)
    contrib = _jax_soft_bins(ang, nb) * w[..., None]
    return np.asarray(jnp.einsum("sc,ksb->kbc", jnp.asarray(wsp), contrib))


def test_ori_hist_matches_jax():
    """K4's plain version vs the JAX kernel and the JAX XLA formula."""
    gauss, lvl, ys, xs, wv = _hist_desc_setup()
    nb = 36
    hist = k.sample_ori_hist(*(torch.from_numpy(a) for a in (gauss, lvl, ys, xs, wv)),
                              nb).numpy()
    assert hist.shape == (16, nb)
    pallas = np.asarray(jax_pallas.sample_ori_hist(
        *(jnp.asarray(a) for a in (gauss, lvl, ys, xs, wv)), nb, pr=48, interpret=True))
    scale = np.abs(pallas).max()
    np.testing.assert_allclose(hist / scale, pallas / scale, atol=2e-2)
    np.testing.assert_allclose(hist, _jax_xla_hist(gauss, lvl, ys, xs, wv, nb),
                               rtol=1e-4, atol=1e-5)


def test_desc_raw_matches_jax():
    """K5's plain version vs the JAX kernel (cosine of the [N, 128]
    descriptor) and the JAX XLA formula."""
    gauss, lvl, ys, xs, wv = _hist_desc_setup(seed=13)
    nb, cells = 8, 16
    rng2 = np.random.default_rng(5)
    theta = rng2.uniform(0, 2 * np.pi, 16).astype(np.float32)
    wsp = rng2.uniform(0, 1, (64, cells)).astype(np.float32)
    args = (gauss, lvl, ys, xs, theta, wv, wsp)
    raw = k.sample_desc_raw(*(torch.from_numpy(a) for a in args), nb).numpy()
    assert raw.shape == (16, nb, cells)
    pallas = np.asarray(jax_pallas.sample_desc_raw(
        *(jnp.asarray(a) for a in args), nb=nb, cells=cells, pr=48, interpret=True))
    for a, b in zip(np.swapaxes(raw, 1, 2).reshape(16, -1),
                    np.swapaxes(pallas, 1, 2).reshape(16, -1)):
        assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.9995
    np.testing.assert_allclose(raw, _jax_xla_desc_raw(*args, nb), rtol=1e-4, atol=1e-5)


def test_separable_grid_matches_jax():
    """K6's plain version vs the JAX separable kernel, and vs the JAX XLA
    gather on the expanded grid."""
    rng2 = np.random.default_rng(7)
    gauss = rng2.normal(size=(3, 96, 160)).astype(np.float32)
    lvl = rng2.integers(0, 3, 16).astype(np.int32)
    gr = gc = 12
    cy = rng2.uniform(20, 76, 16).astype(np.float32)
    cx = rng2.uniform(20, 140, 16).astype(np.float32)
    rad = rng2.uniform(5.0, 14.0, 16).astype(np.float32)
    c1d = (np.arange(gr, dtype=np.float32) + 0.5) / gr * 2.0 - 1.0
    ys_rows = cy[:, None] + rad[:, None] * c1d[None, :]
    xs_cols = cx[:, None] + rad[:, None] * c1d[None, :]
    ys_rows[0] -= cy[0]                          # half its rows above the image
    args = (gauss, lvl, ys_rows, xs_cols)
    got = tuple(o.numpy() for o in k.sample_grad_patches_sep(
        *(torch.from_numpy(a) for a in args)))
    assert got[0].shape == (16, gr * gc)
    ys = np.broadcast_to(ys_rows[:, :, None], (16, gr, gc)).reshape(16, -1)
    xs = np.broadcast_to(xs_cols[:, None, :], (16, gr, gc)).reshape(16, -1)
    ref = _xla_reference(gauss, lvl, ys, xs)
    assert not ref[2].all()
    np.testing.assert_array_equal(got[2], ref[2])
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a[ref[2]], b[ref[2]], atol=1e-5)
    pdx, pdy, pinb = (np.asarray(o) for o in jax_pallas.sample_grad_patches_sep(
        *(jnp.asarray(a) for a in args), pr=48, interpret=True))
    np.testing.assert_array_equal(got[2], pinb)
    m = got[2]
    for a, b in ((got[0], pdx), (got[1], pdy)):
        scale = np.maximum(np.abs(a[m]), 0.05)
        assert np.median(np.abs(a[m] - b[m]) / scale) < 8e-3

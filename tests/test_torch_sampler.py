"""Kernel K1 (cusift_tpu_torch/kernels/sampler.py) against the JAX package.

On the CPU the wrapper takes its plain torch version; it is held against
the JAX Pallas kernel run in interpret mode with f32 dots
(`sample_grad_patches(..., interpret=True, bf16_dots=False)`) and against
the JAX XLA path (`bilinear_sample_pair` over `image_gradients`), at
atol 1e-5 on in-image samples: float32, same formula.  These are twins of
tests/test_pallas_sampler.py; K4-K6 are in test_torch_sampler_fused.py.
The single-channel `bilinear_sample` is held to the JAX one at 1e-5, in
and out of bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.ops.gaussian import image_gradients
from cusift_tpu.ops.pallas.sampler import sample_grad_patches as jax_patches
from cusift_tpu.ops.sampling import bilinear_sample_pair
from cusift_tpu_torch.kernels import sampler as k1
from cusift_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(2)

ATOL = 1e-5


def _setup(rng, L=4, H=96, W=160, N=16, S=144, spread=15.0):
    gauss = rng.normal(size=(L, H, W)).astype(np.float32)
    lvl = rng.integers(0, L, N).astype(np.int32)
    cy = rng.uniform(0, H, N).astype(np.float32)
    cx = rng.uniform(0, W, N).astype(np.float32)
    ys = cy[:, None] + rng.uniform(-spread, spread, (N, S)).astype(np.float32)
    xs = cx[:, None] + rng.uniform(-spread, spread, (N, S)).astype(np.float32)
    return gauss, lvl, ys.astype(np.float32), xs.astype(np.float32)


def _xla_reference(gauss, lvl, ys, xs):
    gdx, gdy = image_gradients(jnp.asarray(gauss))
    out = bilinear_sample_pair(jnp.stack([gdx, gdy], -1), jnp.asarray(lvl),
                               jnp.asarray(ys), jnp.asarray(xs))
    return tuple(np.asarray(o) for o in out)


def _port(gauss, lvl, ys, xs):
    out = k1.sample_grad_patches(*(torch.from_numpy(a) for a in (gauss, lvl, ys, xs)))
    return tuple(o.numpy() for o in out)


def _pallas(gauss, lvl, ys, xs, pr):
    out = jax_patches(*(jnp.asarray(a) for a in (gauss, lvl, ys, xs)), pr=pr,
                      interpret=True, bf16_dots=False)
    return tuple(np.asarray(o) for o in out)


def _assert_close(got, ref, mask=None):
    dx, dy, inb = got
    rdx, rdy, rinb = ref
    m = rinb if mask is None else mask
    np.testing.assert_array_equal(inb, rinb)
    np.testing.assert_allclose(dx[m], rdx[m], atol=ATOL)
    np.testing.assert_allclose(dy[m], rdy[m], atol=ATOL)


def test_matches_xla_path(rng):
    args = _setup(rng)
    got = _port(*args)
    _assert_close(got, _xla_reference(*args))
    _assert_close(got, _pallas(*args, pr=48))


def test_small_level_padding(rng):
    # levels smaller than one TPU patch need no padding here
    args = _setup(rng, L=2, H=24, W=40, N=8, S=36, spread=6.0)
    got = _port(*args)
    _assert_close(got, _xla_reference(*args))
    _assert_close(got, _pallas(*args, pr=32))


def test_border_gradients_zero(rng):
    # samples exactly on the first/last row see zero y-gradients
    gauss = rng.normal(size=(1, 64, 128)).astype(np.float32)
    n, s = 8, 16
    ys = np.concatenate([np.zeros((n // 2, s)),
                         np.full((n // 2, s), 63.0)]).astype(np.float32)
    xs = np.tile(np.linspace(1.0, 126.0, s)[None, :], (n, 1)).astype(np.float32)
    lvl = np.zeros(n, np.int32)
    dx, dy, inb = _port(gauss, lvl, ys, xs)
    assert inb.all()
    np.testing.assert_allclose(dy, 0.0, atol=1e-6)
    _assert_close((dx, dy, inb), _xla_reference(gauss, lvl, ys, xs))
    _assert_close((dx, dy, inb), _pallas(gauss, lvl, ys, xs, pr=32))


def test_non_group_multiple_slot_count(rng):
    """Any slot count works (the TPU slot group G is gone), and extra slots
    change nothing in the others."""
    gauss, lvl, ys, xs = _setup(rng, N=12)
    dx, dy, inb = _port(gauss, lvl, ys, xs)
    assert dx.shape == ys.shape and dy.shape == ys.shape
    pad = lambda a: np.concatenate([a, a[:4]])
    dx2, dy2, _ = _port(gauss, pad(lvl), pad(ys), pad(xs))
    np.testing.assert_array_equal(dx, dx2[:12])
    np.testing.assert_array_equal(dy, dy2[:12])
    _assert_close((dx, dy, inb), _pallas(gauss, lvl, ys, xs, pr=48))


def test_span_limit_margin(rng):
    """Samples spread over the ori stage's span read the right gradients."""
    L, H, W = 2, 256, 384
    gauss = rng.normal(size=(L, H, W)).astype(np.float32)
    n, s = 8, 64
    span = 37.9
    half = span / 2
    ys = np.stack([np.linspace(c - half, c + half, s)
                   for c in np.full(n, 103.9)]).astype(np.float32)
    xs = np.stack([np.linspace(c - half, c + half, s)
                   for c in np.full(n, 200.0)]).astype(np.float32)
    lvl = np.zeros(n, np.int32)
    got = _port(gauss, lvl, ys, xs)
    ref = _xla_reference(gauss, lvl, ys, xs)
    _assert_close(got, ref, mask=np.ones_like(ref[2]))
    pr = -(-(int(span) + 12) // 8) * 8            # the reference's patch rows
    _assert_close(got, _pallas(gauss, lvl, ys, xs, pr=pr),
                  mask=np.ones_like(ref[2]))


def test_levels_clip_and_outside_samples(rng):
    """Out-of-range levels clip to [0, L-1]; outside samples report inb
    False and clamp like the reference."""
    gauss, lvl, ys, xs = _setup(rng, L=3, N=10, spread=40.0)
    lvl = np.array([-2, -1, 0, 1, 2, 3, 7, 0, 1, 2], np.int32)
    got = _port(gauss, lvl, ys, xs)
    ref = _xla_reference(gauss, np.clip(lvl, 0, 2), ys, xs)
    assert not ref[2].all()
    _assert_close(got, ref, mask=np.ones_like(ref[2]))


def test_grid_and_method_dispatch(rng):
    """sample_grad_grid expands row-major; method 'xla' is the plain path;
    the reference's 'fused' and 'separable' sample pairs through K1 (its
    XLA gather there computes the same function), and 'separable' grids
    through K6."""
    gauss = torch.from_numpy(rng.normal(size=(2, 48, 64)).astype(np.float32))
    lvl = torch.tensor([0, 1, 1], dtype=torch.int32)
    ys_rows = torch.tensor([[5.5, 9.0, 20.2], [1.0, 2.0, 3.0], [40.0, 46.5, 47.0]])
    xs_cols = torch.tensor([[3.0, 7.5], [60.0, 62.9], [0.0, 31.0]])
    got = tsampling.sample_grad_grid(gauss, lvl, ys_rows, xs_cols)
    ys = ys_rows[:, :, None].expand(3, 3, 2).reshape(3, 6)
    xs = xs_cols[:, None, :].expand(3, 3, 2).reshape(3, 6)
    ref = tsampling.sample_grad_pair(gauss, lvl, ys, xs, method="xla")
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for method in ("fused", "separable"):
        pair = tsampling.sample_grad_pair(gauss, lvl, ys, xs, method=method)
        grid = tsampling.sample_grad_grid(gauss, lvl, ys_rows, xs_cols, method=method)
        for a, b, r in zip(pair, grid, ref):
            assert torch.equal(a, r) and torch.equal(b, r)
    with pytest.raises(ValueError, match="unknown sampler"):
        tsampling.sample_grad_pair(gauss, lvl, ys, xs, method="mxu")



def test_bilinear_sample_matches_jax(rng):
    """The single-channel sampler against the JAX one at ATOL, with points
    inside, on the borders and outside (clamped values, the same mask)."""
    from cusift_tpu.ops.sampling import bilinear_sample as jax_bilinear

    gauss, lvl, ys, xs = _setup(rng, L=3, H=40, W=56, N=24, S=36, spread=30.0)
    ys[0, :6] = 0.0
    xs[1, :6] = 55.0
    ys[2, :6] = 39.0
    rv, rinb = jax_bilinear(*(jnp.asarray(a) for a in (gauss, lvl, ys, xs)))
    v, inb = tsampling.bilinear_sample(*(torch.from_numpy(a) for a in (gauss, lvl, ys, xs)))
    rinb = np.asarray(rinb)
    assert 0.2 < rinb.mean() < 0.9
    np.testing.assert_array_equal(inb.numpy(), rinb)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=ATOL, rtol=0)

"""The port's Lie-group operations (cusift_tpu_torch/optim/lie.py) against
the JAX package's, on the same numpy inputs.

Tolerance: 1e-6 absolute (float32, the same formulas; only the order of a
few sums differs), at random twists, at small angles (the Taylor branches
below 1e-4 rad) and at exactly zero.  Forward-mode Jacobians of
`se3_exp`/`se3_log` compositions at zero twist are finite and agree with
`jax.jacfwd` to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from cusift_tpu.optim import lie as jlie
from cusift_tpu_torch.optim import lie as tlie

torch.set_num_threads(2)

ATOL = 1e-6


def _twists():
    rng = np.random.default_rng(11)
    big = rng.normal(scale=0.6, size=(16, 6))
    small = rng.normal(scale=1e-5, size=(8, 6))            # Taylor branch
    tiny = np.concatenate([rng.normal(size=(4, 3)), rng.normal(scale=1e-9, size=(4, 3))], -1)
    return np.concatenate([big, small, tiny, np.zeros((2, 6))]).astype(np.float32)


def _close(got: torch.Tensor, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["so3_exp", "_left_jacobian", "_left_jacobian_inv", "hat"])
def test_rotation_vector_maps_match_jax(name):
    w = _twists()[:, 3:]
    _close(getattr(tlie, name)(torch.from_numpy(w)), getattr(jlie, name)(jnp.asarray(w)))


def test_se3_exp_log_match_jax():
    xi = _twists()
    r, t = tlie.se3_exp(torch.from_numpy(xi))
    rj, tj = jlie.se3_exp(jnp.asarray(xi))
    _close(r, rj)
    _close(t, tj)
    # log of the same (float32) rotations, the identity among them
    _close(tlie.so3_log(torch.tensor(np.asarray(rj))), jlie.so3_log(rj))
    _close(tlie.se3_log(torch.tensor(np.asarray(rj)), torch.tensor(np.asarray(tj))),
           jlie.se3_log(rj, tj))


def test_group_operations_match_jax():
    xi = _twists()
    ra, ta = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))
    rb, tb = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi[::-1].copy())))
    p = np.random.default_rng(3).normal(size=(len(xi), 3)).astype(np.float32)
    T = torch.from_numpy
    for got, ref in zip(tlie.compose(T(ra), T(ta), T(rb), T(tb)),
                        jlie.compose(ra, ta, rb, tb)):
        _close(got, ref)
    for got, ref in zip(tlie.inverse(T(ra), T(ta)), jlie.inverse(ra, ta)):
        _close(got, ref)
    for got, ref in zip(tlie.retract(T(ra), T(ta), T(xi)), jlie.retract(ra, ta, xi)):
        _close(got, ref)
    _close(tlie.transform(T(ra), T(ta), T(p)), jlie.transform(ra, ta, p), atol=1e-5)


def test_jacobian_at_zero_twist_matches_jacfwd():
    """d/dxi log(exp(xi) T) at xi = 0: the Taylor branches keep it finite."""
    rng = np.random.default_rng(5)
    r0, t0 = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=6), jnp.float32)))

    def jf(xi):
        dr, dt = jlie.se3_exp(xi)
        return jlie.se3_log(*jlie.compose(dr, dt, r0, t0))

    def tf(xi):
        dr, dt = tlie.se3_exp(xi)
        return tlie.se3_log(*tlie.compose(dr, dt, torch.from_numpy(r0), torch.from_numpy(t0)))

    for xi in (np.zeros(6, np.float32), np.full(6, 1e-6, np.float32)):
        ref = np.asarray(jax.jacfwd(jf)(jnp.asarray(xi)))
        got = jacfwd(tf)(torch.from_numpy(xi)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)

"""Kernel K3 (cusift_tpu_torch/kernels/octave.py) against the JAX package.

On the CPU the wrapper takes its plain torch version (levels blurred
straight from the base, DoG, 26-neighbour score).  It is held against the
JAX Pallas kernel `fused_octave` run in interpret mode on the base of
`tests/test_pallas_sampler.py::test_fused_octave_matches_xla` and on a
[3, H, W] batch built like that test's from a more detailed image (more
extrema): levels and DoG within atol 1e-5 (float32, the same
direct-from-base taps summed in another order), score masks equal and
values within 1e-5.  The port's batch equals its single-frame calls bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import SiftConfig as JaxSiftConfig
from cusift_tpu.data.synthetic import textured_image
from cusift_tpu.ops.pallas.octave import fused_octave as jax_fused_octave
from cusift_tpu.ops.pyramid import initial_level
from cusift_tpu_torch import SiftConfig
from cusift_tpu_torch.kernels import octave as k3

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture(scope="module")
def bases(test_image):
    """The JAX test's octave-0 base [H, W], and a [3, H, W] batch of a
    detailed image's base."""
    base = np.asarray(initial_level(jnp.asarray(test_image), JaxSiftConfig()))
    img = textured_image(240, 320, seed=6, blobs=400, detail=0.25, detail_octaves=2)
    rich = np.asarray(initial_level(jnp.asarray(img), JaxSiftConfig()))
    batch = np.stack([rich, 0.5 * rich + 0.1, rich[::-1]]).astype(np.float32)
    return base, batch


def _jax(base):
    h, w = base.shape[-2:]
    out = jax_fused_octave(jnp.asarray(base), JaxSiftConfig(), h, w, interpret=True)
    return [np.asarray(o) for o in out]


def _port(base):
    return [o.numpy() for o in k3.fused_octave(torch.from_numpy(base.copy()), SiftConfig())]


def _assert_close(got, ref):
    for a, b, name in zip(got[:2], ref[:2], ("samp", "dog")):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)
    fin = np.isfinite(ref[2])
    np.testing.assert_array_equal(np.isfinite(got[2]), fin)
    np.testing.assert_allclose(got[2][fin], ref[2][fin], atol=ATOL)


@pytest.mark.parametrize("which,extrema", [("single", 10), ("batch", 500)])
def test_fused_octave_matches_jax(bases, which, extrema):
    base = bases[0] if which == "single" else bases[1]
    got = _port(base)
    assert np.isfinite(got[2]).sum() >= extrema
    _assert_close(got, _jax(base))


def test_fused_octave_batch_equals_singles(bases):
    batch = _port(bases[1])
    for i, frame in enumerate(bases[1]):
        for a, b in zip(_port(np.ascontiguousarray(frame)), batch):
            np.testing.assert_array_equal(a, b[i])


def test_fused_octave_rejects_small_or_odd_input():
    """Off the CPU the wrapper launches or raises: a device without a
    kernel raises, and so does an octave smaller than its reflect pad."""
    with pytest.raises(ValueError, match="no kernel"):
        k3.fused_octave(torch.zeros(64, 64, device="meta"), SiftConfig())
    # the plain version pads level by level and takes any size the
    # reflect pad of its widest blur fits in
    samp, dog, score = k3.fused_octave(torch.rand(2, 41, 50), SiftConfig())
    assert samp.shape == (2, 3, 41, 50) and dog.shape == (2, 5, 41, 50)
    assert not torch.isfinite(score[:, :, 0]).any()       # border rows

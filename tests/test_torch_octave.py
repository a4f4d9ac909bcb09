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

The card kernel's geometry comes from `_launch_plan`; it is checked here
for every level count and radius the kernel takes.  The kernel itself
runs only on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
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


PLAN_SHAPES = [(64, 64), (70, 200), (120, 160), (200, 131), (240, 320), (480, 640),
               (960, 1280)]


@pytest.mark.parametrize("nlev", range(3, 9))
@pytest.mark.parametrize("r", [1, 5, 20, 32])
def test_launch_plan_fits_and_covers(nlev, r):
    for h, w in PLAN_SHAPES:
        one = k3._launch_plan(1, h, w, nlev, r)
        assert one["smem_bytes"] <= 232_448
        strips, bands = one["grid"][:2]
        assert strips * k3.STRIP >= w > (strips - 1) * k3.STRIP
        bh = one["band_rows"]
        assert bands * bh >= h > (bands - 1) * bh
        # the level halo: a band's groups of 8 rows cover its rows +- 1
        assert k3.GROUP_ROWS * one["groups"] >= bh + 2
        # the window a group blurs from (2r + 8 rows of the strip + 2r + 2
        # columns) and the next group's 8 rows
        assert one["window_rows"] == 2 * r + 2 * k3.GROUP_ROWS
        assert k3.WINDOW_STRIDE >= k3.STRIP + 2 + 2 * r
        # the row-blurred buffer: every column the horizontal pass reads,
        # with a stride of 1 mod 32
        assert one["vbuf_stride"] >= k3.STRIP + 2 + 2 * r
        assert one["vbuf_stride"] % 32 == 1
        for b in (2, 8):
            plan = k3._launch_plan(b, h, w, nlev, r)
            assert plan["grid"] == (strips, bands, b)
            assert {k: v for k, v in plan.items() if k != "grid"} == \
                {k: v for k, v in one.items() if k != "grid"}


def test_launch_plan_fills_the_card_at_the_batch_octaves():
    """8 frames give at least 2 blocks for each of the 132 SMs at every
    octave K3 runs on in the batch."""
    for h, w in [(960, 1280), (480, 640), (240, 320), (120, 160)]:
        plan = k3._launch_plan(8, h, w, 5, 20)
        assert np.prod(plan["grid"]) >= 2 * 132


def test_launch_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        k3._launch_plan(1, 64, 64, 9, 5)
    with pytest.raises(ValueError):
        k3._launch_plan(1, 64, 64, 5, 33)


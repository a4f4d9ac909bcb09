"""Port pyramid stages (cusift_tpu_torch/ops/gaussian.py, pyramid.py and
the extrema score of detect.py) against the JAX package on the same inputs.

Tolerance: atol 1e-5 for blurs, resizes, levels and DoG (float32, same
taps, another summation order), of both builds ("chain" and "direct");
the direct levels against the chain's 2e-3 (tests/test_pyramid.py:79),
and `extract` with the direct build at test_torch_extract.py's bounds.  The extrema score is a comparison of the
same DoG values, so the masks agree to 99.99% and values are equal where
both are finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import SiftConfig
from cusift_tpu.ops import detect as jdetect
from cusift_tpu.ops import gaussian as jgauss
from cusift_tpu.ops import pyramid as jpyr
from cusift_tpu_torch.data.synthetic import textured_image
from cusift_tpu_torch.ops import detect as tdetect
from cusift_tpu_torch.ops import gaussian as tgauss
from cusift_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(2)

ATOL = 1e-5


def _img(test_image):
    return test_image[:96, :128].copy()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("sigma", [0.7, 1.6, 3.1])
def test_blur_matches_jax(test_image, sigma):
    img = _img(test_image)
    ref = np.asarray(jgauss.blur(jnp.asarray(img), sigma))
    got = tgauss.blur(_t(img), sigma).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(tgauss.gaussian_taps(sigma),
                                  jgauss.gaussian_taps(sigma))


def test_blur_stack_and_backends(test_image):
    """A [L, H, W] stack blurs level by level; every conv_backend value is
    the same blur."""
    img = _img(test_image)
    stack = np.stack([img, img[::-1].copy()])
    ref = np.asarray(jgauss.blur(jnp.asarray(stack), 1.3))
    for backend in ("auto", "vpu", "mxu", "mxu2"):
        got = tgauss.blur(_t(stack), 1.3, backend=backend).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL)
    with pytest.raises(ValueError):
        tgauss.blur(_t(stack), 1.3, backend="tpu")


def test_reflect_pad_needs_room():
    with pytest.raises(ValueError):
        tgauss.blur(torch.zeros(8, 8), 3.0)   # radius 12 >= 8 rows


def test_upsample2_matches_jax_resize(test_image):
    img = _img(test_image)[:30, :40]
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (60, 80),
                                      method="bilinear"))
    got = tgauss.upsample2(_t(img)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_gradients_and_downsample_match_jax(test_image):
    img = _img(test_image)
    rdx, rdy = jgauss.image_gradients(jnp.asarray(img))
    dx, dy = tgauss.image_gradients(_t(img))
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), atol=1e-7)
    np.testing.assert_allclose(dy.numpy(), np.asarray(rdy), atol=1e-7)
    np.testing.assert_array_equal(tgauss.downsample2(_t(img)).numpy(),
                                  np.asarray(jgauss.downsample2(jnp.asarray(img))))


@pytest.mark.parametrize("upscale", [False, True])
def test_initial_level_and_octave_matches_jax(test_image, upscale):
    img = _img(test_image)
    cfg = SiftConfig(upscale=upscale)
    rbase = jpyr.initial_level(jnp.asarray(img), cfg)
    base = tpyr.initial_level(_t(img), cfg)
    np.testing.assert_allclose(base.numpy(), np.asarray(rbase), atol=ATOL)
    rlev = jnp.stack(jpyr.octave_levels(rbase, cfg))
    lev = torch.stack(tpyr.octave_levels(_t(np.asarray(rbase)), cfg))
    np.testing.assert_allclose(lev.numpy(), np.asarray(rlev), atol=ATOL)
    np.testing.assert_allclose((lev[1:] - lev[:-1]).numpy(),
                               np.asarray(rlev[1:] - rlev[:-1]), atol=ATOL)


# tests/test_pyramid.py::test_octave_levels_direct_matches_chain: the
# direct levels against the chain's, the taps' truncation
DIRECT_VS_CHAIN = 2e-3


@pytest.mark.parametrize("shape", [(120, 160), (2, 60, 130), (16, 20)])
def test_octave_levels_direct_matches_jax_and_chain(shape):
    """Each level of the direct build against the JAX package's direct
    build (ATOL; the same banded operators, another summation order) and
    against the port's chain; a [B, H, W] batch, and an axis shorter than
    the shared radius (20 px), where the reflection repeats."""
    base = np.random.default_rng(5).random(shape, dtype=np.float32)
    cfg = SiftConfig(num_octaves=1)
    ref = jpyr.octave_levels_direct(jnp.asarray(base), cfg)
    got = tpyr.octave_levels(_t(base), SiftConfig(num_octaves=1, pyramid_impl="direct"))
    assert len(got) == len(ref) == cfg.scales_per_octave + 3
    for g, r in zip(got, ref):
        assert g.shape == base.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    if min(shape[-2:]) > 13:            # the chain's largest radius
        chain = tpyr.octave_levels(_t(base), cfg)
        for g, c in zip(got, chain):
            assert (g - c).abs().max().item() < DIRECT_VS_CHAIN


@pytest.mark.parametrize("impl,upscale", [("chain", False), ("chain", True),
                                          ("direct", False)])
def test_build_pyramid_matches_jax(test_image, impl, upscale):
    """tests/test_pyramid.py's shapes (octave o is (H >> o, W >> o) of the
    base) and DoG = level differences, exactly; levels and DoG against the
    JAX package within ATOL."""
    img = _img(test_image)
    cfg = SiftConfig(upscale=upscale, pyramid_impl=impl)
    ref = jpyr.build_pyramid(jnp.asarray(img), cfg)
    got = tpyr.build_pyramid(_t(img), cfg)
    assert len(got) == len(ref) == cfg.num_octaves_for(*img.shape)
    h, w = (2 * d if upscale else d for d in img.shape)
    for o, (g, r) in enumerate(zip(got, ref)):
        assert g.gauss.shape == (cfg.scales_per_octave + 3, h >> o, w >> o)
        assert g.dog.shape == (cfg.scales_per_octave + 2, h >> o, w >> o)
        assert torch.equal(g.dog, g.gauss[1:] - g.gauss[:-1])
        np.testing.assert_allclose(g.gauss.numpy(), np.asarray(r.gauss), atol=ATOL)
        np.testing.assert_allclose(g.dog.numpy(), np.asarray(r.dog), atol=ATOL)


def test_extract_direct_matches_jax(test_image):
    """extract with pyramid_impl="direct" against the JAX package's, at
    tests/test_torch_extract.py's end-to-end bounds but for position and
    scale, 2e-3: the two direct builds' levels differ by 2e-7 (matmuls
    summed in another order), and the sub-pixel refinement of one poorly
    conditioned keypoint of 56 turns that into 1.04e-3 px (the chain
    build's worst on the same image is 4.4e-4)."""
    from cusift_tpu.models import sift as jsift
    from cusift_tpu_torch.convert import to_numpy
    from cusift_tpu_torch.models import sift as tsift

    cfg = SiftConfig(max_kpts=256, max_kpts_per_octave=128, num_octaves=3,
                     pyramid_impl="direct")
    ref = to_numpy(jsift.extract(jnp.asarray(test_image), cfg))
    got = to_numpy(tsift.extract(_t(test_image), cfg))
    vr, vg = ref["valid"], got["valid"]
    assert vr.sum() > 40
    assert (vr == vg).mean() >= 0.99
    both = vr & vg
    for name in ("x", "y", "sigma"):
        np.testing.assert_allclose(got[name][both], ref[name][both], atol=2e-3,
                                   err_msg=name)
    dth = np.angle(np.exp(1j * (got["orientation"][both] - ref["orientation"][both])))
    np.testing.assert_allclose(dth, 0.0, atol=1e-3)
    np.testing.assert_allclose(got["desc"][both], ref["desc"][both], atol=1e-4)


@pytest.mark.parametrize("score_dtype", ["f32", "bf16"])
def test_extrema_score_matches_jax(score_dtype):
    img = textured_image(96, 128, seed=4, blobs=100, detail=0.25)
    cfg = SiftConfig(score_dtype=score_dtype)
    base = jpyr.initial_level(jnp.asarray(img), cfg)
    lev = jnp.stack(jpyr.octave_levels(base, cfg))
    dog = np.asarray(lev[1:] - lev[:-1])
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if score_dtype == "bf16"
                else (jnp.float32, torch.float32))
    ref = np.asarray(jdetect.extrema_score(jnp.asarray(dog).astype(jdt), cfg)
                     .astype(jnp.float32))
    got = tdetect.extrema_score(_t(dog).to(tdt), cfg)
    assert got.dtype == tdt
    got = got.to(torch.float32).numpy()
    fin_r, fin_g = np.isfinite(ref), np.isfinite(got)
    assert fin_r.sum() > 10
    assert (fin_r == fin_g).mean() >= 0.9999
    both = fin_r & fin_g
    np.testing.assert_array_equal(got[both], ref[both])

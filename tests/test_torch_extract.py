"""Port orientation, descriptors and end-to-end extraction
(cusift_tpu_torch/ops/orientation.py, describe.py, models/sift.py) against
the JAX package.

Stage tests feed both packages the JAX keypoints and slots of octave 0:
histograms and descriptors agree to rtol 1e-4 / atol 1e-5 (float32, same
formulas, another contraction order).  End to end on the 240x320 test
image, the pyramids differ by float32 rounding, so the valid masks must
agree on 99% of slots and the agreeing slots to atol 1e-3 in position,
scale and orientation and 1e-4 in the descriptor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import SiftConfig
from cusift_tpu.models import sift as jsift
from cusift_tpu.ops import describe as jdesc
from cusift_tpu.ops import orientation as jori
from cusift_tpu.ops.detect import detect_from_score
from cusift_tpu_torch.convert import from_numpy, to_numpy
from cusift_tpu_torch.data.synthetic import textured_image
from cusift_tpu_torch.models import sift as tsift
from cusift_tpu_torch.ops import describe as tdesc
from cusift_tpu_torch.ops import keypoints as tkp
from cusift_tpu_torch.ops import orientation as tori

torch.set_num_threads(2)

CFG = SiftConfig(max_kpts=512, max_kpts_per_octave=256)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def stages():
    """JAX intermediates of octave 0 of a detailed 240x320 image."""
    img = textured_image(240, 320, seed=6, blobs=400, detail=0.25,
                         detail_octaves=2)
    samp, dog, score = jsift._octave_planes(jnp.asarray(img), CFG)[0]
    kps = detect_from_score(dog, score, 0, CFG)
    hist = jori.orientation_histograms(samp, kps, CFG, level_base=1)
    theta, ok = jori.dominant_orientations(hist, CFG)
    slots = jdesc.compact_slots(kps, theta, ok, CFG.desc_slots(0))
    desc, slot_valid = jdesc.descriptors(samp, slots, CFG, level_base=1)
    return dict(samp=np.asarray(samp), kps=to_numpy(kps),
                hist=np.asarray(hist), theta=np.asarray(theta),
                ok=np.asarray(ok), slots=to_numpy(slots),
                desc=np.asarray(desc), slot_valid=np.asarray(slot_valid))


def test_orientation_histograms_match_jax(stages):
    kps = from_numpy(tkp.Keypoints, stages["kps"], device="cpu")
    assert stages["kps"]["valid"].sum() > 50
    hist = tori.orientation_histograms(_t(stages["samp"]), kps, CFG, level_base=1)
    np.testing.assert_allclose(hist.numpy(), stages["hist"], rtol=1e-4, atol=1e-5)


def test_dominant_orientations_match_jax(stages):
    theta, ok = tori.dominant_orientations(_t(stages["hist"]), CFG)
    np.testing.assert_array_equal(ok.numpy(), stages["ok"])
    np.testing.assert_allclose(theta.numpy(), stages["theta"], atol=1e-5)


def test_compact_slots_match_jax(stages):
    """Both slots of a keypoint tie; the order must be lax.top_k's."""
    kps = from_numpy(tkp.Keypoints, stages["kps"], device="cpu")
    slots = tdesc.compact_slots(kps, _t(stages["theta"]), _t(stages["ok"]),
                                CFG.desc_slots(0))
    got = to_numpy(slots)
    for name, ref in stages["slots"].items():
        np.testing.assert_array_equal(got[name], ref, err_msg=name)


def test_descriptors_match_jax(stages):
    slots = from_numpy(tdesc.Slots, stages["slots"], device="cpu")
    desc, slot_valid = tdesc.descriptors(_t(stages["samp"]), slots, CFG,
                                         level_base=1)
    np.testing.assert_array_equal(slot_valid.numpy(), stages["slot_valid"])
    np.testing.assert_allclose(desc.numpy(), stages["desc"], rtol=1e-4, atol=1e-5)


def test_extract_matches_jax(test_image):
    ref = to_numpy(jsift.extract(jnp.asarray(test_image), CFG))
    got = to_numpy(tsift.extract(_t(test_image), CFG))
    assert got["desc"].shape == (CFG.total_kpts, 128)
    vr, vg = ref["valid"], got["valid"]
    assert vr.sum() > 40
    assert (vr == vg).mean() >= 0.99
    both = vr & vg
    for name in ("x", "y", "sigma"):
        np.testing.assert_allclose(got[name][both], ref[name][both], atol=1e-3,
                                   err_msg=name)
    dth = np.angle(np.exp(1j * (got["orientation"][both] - ref["orientation"][both])))
    np.testing.assert_allclose(dth, 0.0, atol=1e-3)
    np.testing.assert_allclose(got["desc"][both], ref["desc"][both], atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got["desc"][vg], axis=-1), 1.0,
                               atol=1e-5)
    for name, a in got.items():                       # dead lanes are zero
        if name != "valid":
            assert not a[~vg].any(), name


def test_extract_batch_is_per_frame(test_image):
    cfg = SiftConfig(max_kpts=128, max_kpts_per_octave=64, num_octaves=2)
    imgs = np.stack([test_image[:96, :128], test_image[-96:, -128:]])
    batch = tsift.extract_batch(_t(imgs), cfg)
    for i in range(2):
        one = tsift.extract(_t(imgs[i]), cfg)
        for name, a, b in zip(one._fields, batch, one):
            assert torch.equal(a[i], b), name



@pytest.mark.parametrize("entry", ["extract", "extract_batch"])
def test_unknown_fused_pyramid_raises(test_image, entry):
    """The port rejects a fused_pyramid it does not know, where the
    reference quietly builds the XLA pyramid (an accepted divergence)."""
    from cusift_tpu_torch import SiftConfig as TorchSiftConfig

    cfg = TorchSiftConfig(max_kpts=128, max_kpts_per_octave=64, num_octaves=2,
                          fused_pyramid="palas")
    img = _t(test_image[:96, :128])
    with pytest.raises(ValueError, match="unknown fused_pyramid 'palas'"):
        getattr(tsift, entry)(img if entry == "extract" else img[None], cfg)

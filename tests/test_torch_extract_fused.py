"""The port's opt-in extraction paths end to end against the JAX package:
the fused octave (K3) with the fused samplers (K4/K5) or the separable
one (K6 for orientation, K1 for descriptors).

The reference runs `extract` with `fused_pyramid="pallas"` on the 240x320
test image: its K3 runs in interpret mode off the TPU
(`cusift_tpu/models/sift.py:110`), and its sampler resolves to the XLA
formulas on the CPU (its "fused" and "separable" Pallas samplers cannot run
here).  The port's plain versions of K3-K6 compute those same functions in
float32, so every port variant is held to the bounds of
`test_torch_extract.py::test_extract_matches_jax`: the valid slots agree
but for 1% of the capacity, the agreeing slots within 1e-3 in position,
scale and orientation and 1e-4 in the descriptor, dead lanes zero.  The
blurs sum their taps in another order than the reference's kernel, so a
keypoint at a threshold may appear in one package only; that shifts the
slots after it, so slots are paired by keypoint (position, scale and
orientation within 1e-3), not by index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import SiftConfig as JaxSiftConfig
from cusift_tpu.models import sift as jsift
from cusift_tpu_torch import SiftConfig
from cusift_tpu_torch.convert import to_numpy
from cusift_tpu_torch.kernels import octave as k3
from cusift_tpu_torch.models import sift as tsift

torch.set_num_threads(2)

KW = dict(max_kpts=512, max_kpts_per_octave=256)


@pytest.fixture(scope="module")
def jax_fused(test_image):
    """The one JAX extract of this file: fused_pyramid="pallas"."""
    cfg = JaxSiftConfig(**KW, fused_pyramid="pallas")
    return to_numpy(jsift.extract(jnp.asarray(test_image), cfg))


def _pair_slots(ref, got, tol=1e-3):
    """(i, j) of valid slots of ref and got that are the same keypoint and
    orientation: each other's nearest, within tol in x, y, sigma and angle."""
    ir, jg = np.flatnonzero(ref["valid"]), np.flatnonzero(got["valid"])
    cost = np.zeros((ir.size, jg.size))
    for name in ("x", "y", "sigma"):
        cost = np.maximum(cost, np.abs(ref[name][ir, None] - got[name][None, jg]))
    dth = ref["orientation"][ir, None] - got["orientation"][None, jg]
    cost = np.maximum(cost, np.abs(np.angle(np.exp(1j * dth))))
    a, b = np.argmin(cost, 1), np.argmin(cost, 0)
    keep = [(i, a[i]) for i in range(ir.size)
            if b[a[i]] == i and cost[i, a[i]] < tol]
    return [ir[i] for i, _ in keep], [jg[j] for _, j in keep]


@pytest.mark.parametrize("kw", [dict(fused_pyramid="pallas", sampler="fused"),
                                dict(fused_pyramid="pallas_hbm", sampler="fused"),
                                dict(fused_pyramid="pallas", sampler="separable")],
                         ids=["pallas-fused", "pallas_hbm-fused", "pallas-separable"])
def test_fused_extract_matches_jax(test_image, jax_fused, kw):
    ref = jax_fused
    got = to_numpy(tsift.extract(torch.from_numpy(test_image.copy()),
                                 SiftConfig(**KW, **kw)))
    assert got["desc"].shape == (512, 128)
    vr, vg = ref["valid"], got["valid"]
    assert vr.sum() > 40
    i, j = _pair_slots(ref, got)
    assert vr.sum() + vg.sum() - 2 * len(i) <= 0.01 * vr.size
    np.testing.assert_allclose(got["desc"][j], ref["desc"][i], atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got["desc"][vg], axis=-1), 1.0,
                               atol=1e-5)
    for name, a in got.items():                       # dead lanes are zero
        if name != "valid":
            assert not a[~vg].any(), name


def test_fused_extract_batch_is_per_frame(test_image, monkeypatch):
    """extract_batch builds each octave of all frames in one K3 call (the
    chain below the 64-px gate) and equals extract frame by frame."""
    cfg = SiftConfig(max_kpts=128, max_kpts_per_octave=64, num_octaves=3,
                     fused_pyramid="pallas_hbm", sampler="fused")
    imgs = np.stack([test_image[:128, :160], test_image[-128:, -160:],
                     test_image[56:184, 80:240]])
    shapes = []
    plain = k3.fused_octave_plain
    monkeypatch.setattr(k3, "fused_octave_plain",
                        lambda base, c: shapes.append(tuple(base.shape)) or plain(base, c))
    batch = tsift.extract_batch(torch.from_numpy(imgs), cfg)
    assert shapes == [(3, 128, 160), (3, 64, 80)]      # octave 2 is 32x40
    for i in range(3):
        one = tsift.extract(torch.from_numpy(imgs[i].copy()), cfg)
        for name, a, b in zip(one._fields, batch, one):
            assert torch.equal(a[i], b), name

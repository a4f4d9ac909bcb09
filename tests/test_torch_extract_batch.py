"""`extract_batch` as one batched program (cusift_tpu_torch/models/sift.py),
against the JAX package's `jax.vmap(extract)` and against itself.

* The port's `extract_batch` of a [3, 96, 128] batch against
  `cusift_tpu.models.sift.extract_batch` (the vmap) at the default
  configuration, the port at its default and with sampler="fused": the
  reference's fused samplers are Pallas kernels that run on the TPU only
  (off it they raise; no interpret flag reaches them), and they compute
  the XLA formulas of its default path, which the port's K4/K5 compute too
  (as in `test_torch_extract_fused.py`).  Each frame is held to
  `test_torch_extract.py::test_extract_matches_jax`'s bounds, valid masks
  equal on 99% of slots, the slots valid in both within 1e-3 in position,
  scale and orientation and 1e-4 in the descriptor.
* Batch invariance on the CPU: frame b of batches of 1, 2 and 3 frames
  with different neighbours equals `extract` of that frame bit for bit,
  for the default, "fused", "separable", fused_pyramid="pallas" and
  score_dtype="bf16" configurations.
* Each plain sampler (`kernels/sampler.py`'s K1, K4, K5 and K6 versions,
  `bilinear_sample_pair` and `ops/sampling.py:bilinear_sample`) over a
  [3, ...] batch against per-frame calls of itself, bit for bit, with
  levels outside [0, L - 1] (clipped within the frame), and `top_indices`
  over [B, M] rows against each row alone.

Every input comes from this file's own seeded generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import SiftConfig as JaxSiftConfig
from cusift_tpu.models import sift as jsift
from cusift_tpu_torch import SiftConfig
from cusift_tpu_torch.convert import to_numpy
from cusift_tpu_torch.data.synthetic import textured_image
from cusift_tpu_torch.kernels import sampler as k
from cusift_tpu_torch.models import sift as tsift
from cusift_tpu_torch.ops import sampling
from cusift_tpu_torch.ops.gaussian import image_gradients
from cusift_tpu_torch.ops.keypoints import top_indices

torch.set_num_threads(2)

H, W = 96, 128
KW = dict(max_kpts=256, max_kpts_per_octave=128)


def _frames(n=4):
    """n distinct detailed [96, 128] frames."""
    return np.stack([textured_image(H, W, seed=40 + i, blobs=150, detail=0.25,
                                    detail_octaves=2) for i in range(n)])


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def jax_batch(frames):
    """The one JAX compile of this file: the vmapped extract of 3 frames."""
    return to_numpy(jsift.extract_batch(jnp.asarray(frames[:3]), JaxSiftConfig(**KW)))


@pytest.mark.parametrize("kw", [{}, dict(sampler="fused")], ids=["default", "fused"])
def test_extract_batch_matches_jax_vmap(frames, jax_batch, kw):
    ref = jax_batch
    got = to_numpy(tsift.extract_batch(torch.from_numpy(frames[:3].copy()),
                                       SiftConfig(**KW, **kw)))
    assert got["desc"].shape == (3, KW["max_kpts"], 128)
    for b in range(3):
        vr, vg = ref["valid"][b], got["valid"][b]
        assert vr.sum() > 20, b
        assert (vr == vg).mean() >= 0.99, b
        both = vr & vg
        for name in ("x", "y", "sigma"):
            np.testing.assert_allclose(got[name][b][both], ref[name][b][both], atol=1e-3,
                                       err_msg=f"frame {b} {name}")
        dth = np.angle(np.exp(1j * (got["orientation"][b][both]
                                    - ref["orientation"][b][both])))
        np.testing.assert_allclose(dth, 0.0, atol=1e-3, err_msg=f"frame {b}")
        np.testing.assert_allclose(got["desc"][b][both], ref["desc"][b][both], atol=1e-4,
                                   err_msg=f"frame {b}")


@pytest.mark.parametrize("kw", [{}, dict(sampler="fused"), dict(sampler="separable"),
                                dict(fused_pyramid="pallas"), dict(score_dtype="bf16")],
                         ids=["default", "fused", "separable", "pallas", "bf16"])
def test_frame_does_not_depend_on_its_batch(frames, kw):
    """Frame b of [A], [B, A] and [C, A, D] equals extract of that frame."""
    cfg = SiftConfig(**KW, **kw)
    t = torch.from_numpy(frames.copy())
    one = [tsift.extract(t[i], cfg) for i in range(4)]
    assert int(one[0].valid.sum()) > 20
    for order in ([0], [1, 0], [2, 0, 3]):
        batch = tsift.extract_batch(t[order], cfg)
        for b, i in enumerate(order):
            for name, got, ref in zip(batch._fields, batch, one[i]):
                assert torch.equal(got[b], ref), (order, b, name)


def _sampler_inputs(seed, B=3, L=3, N=24, S=36):
    """A [B, L, H, W] stack and [B, N, ...] slots, levels in [-1, L]."""
    g = np.random.default_rng(seed)
    gauss = g.normal(size=(B, L, 40, 56)).astype(np.float32)
    lvl = g.integers(-1, L + 1, (B, N)).astype(np.int32)
    cy, cx = g.uniform(-5, 45, (B, N, 1)), g.uniform(-5, 61, (B, N, 1))
    ys = (cy + g.uniform(-8, 8, (B, N, S))).astype(np.float32)
    xs = (cx + g.uniform(-8, 8, (B, N, S))).astype(np.float32)
    wv = g.uniform(0, 1, (B, N, S)).astype(np.float32)
    theta = g.uniform(0, 2 * np.pi, (B, N)).astype(np.float32)
    return [torch.from_numpy(a) for a in (gauss, lvl, ys, xs, wv, theta)]


def _per_frame_equal(batched, per_frame):
    for b, outs in enumerate(per_frame):
        for got, ref in zip(batched, outs):
            assert torch.equal(got[b], ref), b


@pytest.mark.parametrize("which", ["k1", "k4", "k5", "k6", "pair", "bilinear"])
def test_plain_samplers_batched_equal_per_frame(which):
    gauss, lvl, ys, xs, wv, theta = _sampler_inputs(len(which))
    B = gauss.shape[0]
    assert bool((lvl < 0).any() and (lvl >= gauss.shape[1]).any())
    if which == "k6":
        ys, xs = ys[..., :12].contiguous(), xs[..., :7].contiguous()
    wsp = torch.from_numpy(np.random.default_rng(9).uniform(0, 1, (ys.shape[-1], 16))
                           .astype(np.float32))
    calls = {
        "k1": lambda g, lv, y, x, w, th: k.sample_grad_patches(g, lv, y, x),
        "k6": lambda g, lv, y, x, w, th: k.sample_grad_patches_sep(g, lv, y, x),
        "k4": lambda g, lv, y, x, w, th: (k.sample_ori_hist(g, lv, y, x, w, 36),),
        "k5": lambda g, lv, y, x, w, th: (k.sample_desc_raw(g, lv, y, x, th, w, wsp, 8),),
        "pair": lambda g, lv, y, x, w, th: k.bilinear_sample_pair(
            torch.stack(image_gradients(g), -1), lv, y, x),
        "bilinear": lambda g, lv, y, x, w, th: sampling.bilinear_sample(g, lv, y, x),
    }[which]
    batched = calls(gauss, lvl, ys, xs, wv, theta)
    per_frame = [calls(gauss[b], lvl[b], ys[b], xs[b], wv[b], theta[b]) for b in range(B)]
    _per_frame_equal(batched, per_frame)
    # a level is clipped within its frame: frame b's slots read only frame b
    moved = gauss.clone()
    moved[1:] += 1.0
    again = calls(moved, lvl, ys, xs, wv, theta)
    for got, ref in zip(again, batched):
        assert torch.equal(got[0], ref[0])


def test_top_indices_rows_are_independent():
    g = np.random.default_rng(21)
    score = torch.from_numpy(g.integers(0, 5, (4, 300)).astype(np.float32))  # many ties
    score[2] = -torch.inf
    idx = top_indices(score, 50)
    for b in range(4):
        assert torch.equal(idx[b], top_indices(score[b], 50))
    assert torch.equal(idx[2], torch.arange(50))                     # ties: lower index

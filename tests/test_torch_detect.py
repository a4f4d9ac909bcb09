"""Port detection (cusift_tpu_torch/ops/detect.py, keypoints.py, mat3.py)
against the JAX package.

`detect_from_score` is fed JAX's own DoG and score, so the compaction sees
identical candidates: `valid` must be equal, and the refined coordinates
and responses agree to atol 1e-4 (closed-form 3x3 solves in float32 with
another operation order).  `detect_octave` and `detect` (every octave, then
the global compaction) are fed JAX's own octaves and held the same way;
`empty_keypoints` and `concat_keypoints` are equal field for field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import SiftConfig
from cusift_tpu.ops import detect as jdetect
from cusift_tpu.ops import keypoints as jkp
from cusift_tpu.ops import mat3 as jmat3
from cusift_tpu.ops import pyramid as jpyr
from cusift_tpu.ops.gaussian import downsample2
from cusift_tpu_torch.convert import from_numpy, to_numpy
from cusift_tpu_torch.data.synthetic import textured_image
from cusift_tpu_torch.ops import detect as tdetect
from cusift_tpu_torch.ops import keypoints as tkp
from cusift_tpu_torch.ops import mat3 as tmat3
from cusift_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def octaves():
    """JAX (dog, score) of octaves 0 and 1 of a detailed 240x320 image."""
    img = textured_image(240, 320, seed=4, blobs=400, detail=0.25,
                         detail_octaves=2)
    cfg = SiftConfig(max_kpts=512, max_kpts_per_octave=256)
    base = jpyr.initial_level(jnp.asarray(img), cfg)
    out = []
    for _ in range(2):
        lev = jpyr.octave_levels(base, cfg)
        gauss = jnp.stack(lev)
        dog = gauss[1:] - gauss[:-1]
        out.append((np.asarray(dog), np.asarray(jdetect.extrema_score(dog, cfg))))
        base = downsample2(lev[cfg.scales_per_octave])
    return cfg, out


@pytest.mark.parametrize("octave", [0, 1])
@pytest.mark.parametrize("refine_iters", [0, 2])
def test_detect_from_score_matches_jax(octaves, octave, refine_iters):
    cfg, planes = octaves
    cfg = dataclasses.replace(cfg, refine_iters=refine_iters)
    dog, score = planes[octave]
    ref = jdetect.detect_from_score(jnp.asarray(dog), jnp.asarray(score),
                                    octave, cfg)
    got = tdetect.detect_from_score(_t(dog), _t(score), octave, cfg)
    r, g = to_numpy(ref), to_numpy(got)
    assert r["valid"].sum() > (100 if octave == 0 else 20)
    np.testing.assert_array_equal(g["valid"], r["valid"])
    v = r["valid"]
    for name in ("xo", "yo", "so", "response"):
        np.testing.assert_allclose(g[name][v], r[name][v], atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(g["level"][v], r["level"][v])
    np.testing.assert_array_equal(g["octave"], r["octave"])
    np.testing.assert_allclose(g["sigma"][v], r["sigma"][v], rtol=1e-5)


def test_topk_keypoints_ties_to_lower_index():
    """Equal responses keep the reference's lax.top_k order."""
    rng = np.random.default_rng(5)
    k = 32
    resp = np.round(rng.normal(size=k), 1).astype(np.float32)  # many ties
    f = rng.normal(size=k).astype(np.float32)
    i = rng.integers(0, 5, k).astype(np.int32)
    arrays = dict(x=f, y=f + 1, sigma=f + 2, response=resp, edgeness=f,
                  octave=i, level=i, xo=f, yo=f, so=f,
                  valid=rng.random(k) > 0.2)
    ref = jkp.topk_keypoints(jkp.Keypoints(**{n: jnp.asarray(a) for n, a in
                                              arrays.items()}), 20)
    got = tkp.topk_keypoints(from_numpy(tkp.Keypoints, arrays, device="cpu"), 20)
    r, g = to_numpy(ref), to_numpy(got)
    for name in r:
        np.testing.assert_array_equal(g[name], r[name], err_msg=name)


def test_mat3_matches_jax():
    rng = np.random.default_rng(7)
    m = rng.normal(size=(64, 3, 3)).astype(np.float32)
    m[0] = 0.0                                    # singular
    m[1, 2] = m[1, 0] + m[1, 1]                   # rank 2
    b = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(tmat3.det3(_t(m)).numpy(),
                               np.asarray(jmat3.det3(jnp.asarray(m))), atol=1e-5)
    np.testing.assert_allclose(tmat3.inv3(_t(m)).numpy()[2:],
                               np.asarray(jmat3.inv3(jnp.asarray(m)))[2:],
                               rtol=1e-4, atol=1e-4)
    x, ok = tmat3.solve3(_t(m), _t(b))
    rx, rok = jmat3.solve3(jnp.asarray(m), jnp.asarray(b))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-4, atol=1e-4)
    assert not ok[0] and bool(torch.isfinite(tmat3.inv3(_t(m))).all())


def test_solve_spd_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(32, 8, 8)).astype(np.float32)
    spd = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(8, dtype=np.float32)
    b = rng.normal(size=(32, 8)).astype(np.float32)
    got = tmat3.solve_spd(_t(spd), _t(b)).numpy()
    ref = np.asarray(jmat3.solve_spd(jnp.asarray(spd), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", spd, got), b, atol=1e-3)
    # a degenerate (rank-1 + ridge) system raises nothing; its garbage is
    # non-finite exactly where the reference's is, for scoring to reject
    v = rng.normal(size=(1, 8, 1)).astype(np.float32)
    deg = v @ np.swapaxes(v, -1, -2) + 1e-10 * np.eye(8, dtype=np.float32)
    got = tmat3.solve_spd(_t(deg), _t(b[:1])).numpy()
    with jax.debug_nans(False):
        ref = np.asarray(jmat3.solve_spd(jnp.asarray(deg), jnp.asarray(b[:1])))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))


@pytest.fixture(scope="module")
def pyramid():
    """The JAX package's three octaves (levels and DoG) of a detailed
    240x320 image, with the config that built them."""
    img = textured_image(240, 320, seed=6, blobs=400, detail=0.25, detail_octaves=2)
    cfg = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
    return cfg, [jpyr.Octave(*(np.asarray(a) for a in o))
                 for o in jpyr.build_pyramid(jnp.asarray(img), cfg)]


def _assert_keypoints_close(got, ref):
    r, g = to_numpy(ref), to_numpy(got)
    np.testing.assert_array_equal(g["valid"], r["valid"])
    v = r["valid"]
    for name in ("x", "y", "xo", "yo", "so", "response"):
        np.testing.assert_allclose(g[name][v], r[name][v], atol=1e-4, err_msg=name)
    for name in ("level", "octave"):
        np.testing.assert_array_equal(g[name][v], r[name][v], err_msg=name)
    np.testing.assert_allclose(g["sigma"][v], r["sigma"][v], rtol=1e-5)
    return int(v.sum())


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_detect_octave_matches_jax(pyramid, octave):
    cfg, octs = pyramid
    o = octs[octave]
    ref = jdetect.detect_octave(jpyr.Octave(jnp.asarray(o.gauss), jnp.asarray(o.dog)),
                                octave, cfg)
    got = tdetect.detect_octave(tpyr.Octave(_t(o.gauss), _t(o.dog)), octave, cfg)
    assert _assert_keypoints_close(got, ref) > (100 if octave == 0 else 5)


def test_detect_matches_jax(pyramid):
    """Every octave, then the global compaction to cfg.max_kpts by
    |response| (ties to the lower lane, as lax.top_k)."""
    cfg, octs = pyramid
    ref = jdetect.detect([jpyr.Octave(jnp.asarray(o.gauss), jnp.asarray(o.dog))
                          for o in octs], cfg)
    got = tdetect.detect([tpyr.Octave(_t(o.gauss), _t(o.dog)) for o in octs], cfg)
    assert got.x.shape == (cfg.max_kpts,)
    assert _assert_keypoints_close(got, ref) > 200


def test_empty_and_concat_keypoints_match_jax():
    ref = jkp.concat_keypoints([jkp.empty_keypoints(5), jkp.empty_keypoints(3)])
    got = tkp.concat_keypoints([tkp.empty_keypoints(5, "cpu"), tkp.empty_keypoints(3, "cpu")])
    r, g = to_numpy(ref), to_numpy(got)
    assert list(g) == list(r)
    for name in r:
        assert g[name].dtype == r[name].dtype and g[name].shape == (8,), name
        np.testing.assert_array_equal(g[name], r[name], err_msg=name)
    rng = np.random.default_rng(9)
    parts = []
    for k in (4, 7):
        f = rng.normal(size=k).astype(np.float32)
        i = rng.integers(0, 4, k).astype(np.int32)
        parts.append(dict(x=f, y=f + 1, sigma=f + 2, response=f - 1, edgeness=f, octave=i,
                          level=i + 1, xo=f, yo=f, so=f, valid=rng.random(k) > 0.5))
    ref = jkp.concat_keypoints([jkp.Keypoints(**{n: jnp.asarray(a) for n, a in p.items()})
                                for p in parts])
    got = tkp.concat_keypoints([from_numpy(tkp.Keypoints, p, device="cpu") for p in parts])
    r, g = to_numpy(ref), to_numpy(got)
    for name in r:
        np.testing.assert_array_equal(g[name], r[name], err_msg=name)

"""Kernel K2 and the port matcher (cusift_tpu_torch/kernels/matcher.py,
ops/match.py) against the JAX package.

On the CPU the wrapper takes its plain torch version; it is held against
the JAX Pallas kernel in interpret mode (`match_pallas(..., interpret=True)`)
and the JAX XLA matcher: `idx` and `ok` equal, `dist` to 1e-5 and `ratio`
to 1e-4 (float32 dot products of unit vectors in another summation
order).  These are twins of tests/test_pallas_matcher.py.

The card kernel computes the scores as 3xTF32 products on the tensor
cores; `_sim_3xtf32` emulates that arithmetic in numpy (round-to-nearest,
ties away, to a 10-bit mantissa; a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in
f32) and holds it within 2e-6 of the f64 scores.  `_launch_plan`'s grid
is checked here too; the kernel itself runs in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import MatchConfig
from cusift_tpu.ops.match import match as jmatch
from cusift_tpu.ops.pallas.matcher import _pallas_top2, match_pallas
from cusift_tpu_torch.convert import to_numpy
from cusift_tpu_torch.data.synthetic import warped_pair
from cusift_tpu_torch.models.sift import extract
from cusift_tpu_torch.config import SiftConfig
from cusift_tpu_torch.kernels import matcher as k2
from cusift_tpu_torch.ops.match import match as tmatch

torch.set_num_threads(2)


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _both(a, va, b, vb, cfg, interpret=None):
    j = tuple(jnp.asarray(x) for x in (a, va, b, vb))
    if interpret is None:
        ref = jmatch(*j, cfg)
    else:
        ref = jmatch(*j, cfg, interpret=interpret)
    got = tmatch(*(torch.from_numpy(x) for x in (a, va, b, vb)), cfg)
    return to_numpy(ref), to_numpy(got)


def _assert_same(r, g):
    np.testing.assert_array_equal(g["idx"], r["idx"])
    np.testing.assert_array_equal(g["ok"], r["ok"])
    np.testing.assert_allclose(g["dist"], r["dist"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g["ratio"], r["ratio"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,m", [(256, 256), (300, 512), (512, 300)])
def test_matches_jax_paths(rng, n, m):
    a, b = _unit(rng, n), _unit(rng, m)
    va = np.ones(n, bool)
    vb = np.ones(m, bool)
    vb[m // 3] = False
    cfg = MatchConfig(ratio_thresh=0.95)
    r, g = _both(a, va, b, vb, cfg)
    _assert_same(r, g)
    pal = to_numpy(match_pallas(*(jnp.asarray(x) for x in (a, va, b, vb)), cfg,
                                interpret=True))
    _assert_same(pal, g)
    assert g["ok"].any()


def test_top2_matches_pallas_interpret(rng):
    """Plain top-2 == the TPU kernel's outputs, including duplicate best
    columns (s1 == s2, first index kept) and invalid columns."""
    a, b = _unit(rng, 100), _unit(rng, 90)
    b[40] = b[10]
    a[3] = b[10]
    vb = np.ones(90, bool)
    vb[::7] = False
    vb[10] = vb[40] = True
    top, idx = _pallas_top2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb),
                            interpret=True)
    gtop, gidx = k2.top2(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(vb))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(gtop.numpy(), np.asarray(top), atol=1e-5)
    assert gidx[3] == 10 and gtop[3, 0] == gtop[3, 1]


def test_all_invalid_b(rng):
    a, b = _unit(rng, 256), _unit(rng, 256)
    va, vb = np.ones(256, bool), np.zeros(256, bool)
    r, g = _both(a, va, b, vb, MatchConfig())
    assert not g["ok"].any()
    _assert_same(r, g)
    top, idx = k2.top2(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(vb))
    assert torch.isneginf(top).all() and not idx.any()


def test_single_valid_candidate_not_vacuous(rng):
    """With one valid B row the second-best is -inf and the ratio is 0;
    the isfinite(s2) guard must reject instead of passing every query."""
    a, b = _unit(rng, 64), _unit(rng, 64)
    vb = np.zeros(64, bool)
    vb[5] = True
    r, g = _both(a, np.ones(64, bool), b, vb, MatchConfig())
    assert not g["ok"].any()
    _assert_same(r, g)


def test_cross_check_branch(rng):
    """The cross-check (reverse top-2 call) == the JAX XLA cross-check and
    the JAX Pallas branch in interpret mode."""
    a, b = _unit(rng, 256), _unit(rng, 300)
    va = np.ones(256, bool)
    va[7] = False
    vb = np.ones(300, bool)
    vb[100] = False
    cfg_x = MatchConfig(ratio_thresh=0.95, cross_check=True, backend="xla")
    cfg_p = MatchConfig(ratio_thresh=0.95, cross_check=True, backend="pallas")
    r, g = _both(a, va, b, vb, cfg_x)
    assert r["ok"].any()
    _assert_same(r, g)
    rp, gp = _both(a, va, b, vb, cfg_p, interpret=True)
    _assert_same(rp, gp)
    np.testing.assert_array_equal(gp["ok"], g["ok"])


def test_no_row_cap(rng):
    """M above the TPU kernel's 8192 VMEM guard takes the same path."""
    a, b = _unit(rng, 16), _unit(rng, 8200)
    vb = np.ones(8200, bool)
    r, g = _both(a, np.ones(16, bool), b, vb, MatchConfig())
    _assert_same(r, g)


def _tf32_rna(x):
    """float32 -> the nearest value with a 10-bit mantissa, ties away from
    zero (PTX cvt.rna.tf32.f32), by bit operations."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _sim_3xtf32(a, b):
    """A @ B.T as the kernel forms it: each operand split into TF32 hi and
    lo words, the three products summed in f32 (small ones first)."""
    ah = _tf32_rna(a)
    al = _tf32_rna(a - ah)
    bh = _tf32_rna(b)
    bl = _tf32_rna(b - bh)
    return (al @ bh.T + ah @ bl.T) + ah @ bh.T


def _top2_np(sim, vb):
    sim = np.where(vb[None, :], sim, -np.inf)
    i1 = np.argmax(sim, axis=1)
    s1 = sim[np.arange(len(sim)), i1]
    sim2 = sim.copy()
    sim2[np.arange(len(sim)), i1] = -np.inf
    return s1, sim2.max(axis=1), i1


def test_tf32_split_is_exact_where_it_should_be():
    x = np.array([1.0, -1.0, 0.5, 1 + 2 ** -10, 1 + 2 ** -11, -(1 + 2 ** -11),
                  1 + 3 * 2 ** -12, 0.0], np.float32)
    np.testing.assert_array_equal(
        _tf32_rna(x), np.array([1.0, -1.0, 0.5, 1 + 2 ** -10, 1 + 2 ** -10,
                                -(1 + 2 ** -10), 1 + 2 ** -10, 0.0], np.float32))
    rng = np.random.default_rng(0)
    y = rng.normal(size=10000).astype(np.float32)
    hi = _tf32_rna(y)
    assert np.all(np.abs(y - hi) <= np.abs(y) * 2.0 ** -11)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0)


def _descs(which, rng):
    if which == "unit":
        return _unit(rng, 700), _unit(rng, 900)
    ia, ib, _ = warped_pair(240, 320, seed=2, blobs=300, detail=0.25,
                            detail_octaves=2)
    cfg = SiftConfig(max_kpts=512)
    fa, fb = extract(ia, cfg, device="cpu"), extract(ib, cfg, device="cpu")
    da = fa.desc[fa.valid].numpy().astype(np.float32)
    db = fb.desc[fb.valid].numpy().astype(np.float32)
    assert len(da) > 100 and len(db) > 100
    return da, db


@pytest.mark.parametrize("which", ["unit", "extracted"])
def test_3xtf32_scores_within_2e6_of_f64(rng, which):
    """The kernel's arithmetic, emulated: scores within 2e-6 of f64, and
    the same best index as top2_plain except at near ties (< 1e-5)."""
    a, b = _descs(which, rng)
    vb = rng.random(len(b)) > 0.1
    s1, s2, i1 = _top2_np(_sim_3xtf32(a, b), vb)
    r1, r2, _ = _top2_np(a.astype(np.float64) @ b.astype(np.float64).T, vb)
    assert np.abs(s1 - r1).max() <= 2e-6 and np.abs(s2 - r2).max() <= 2e-6
    ptop, pidx = k2.top2_plain(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(vb))
    ptop, pidx = ptop.numpy(), pidx.numpy()
    near_tie = (ptop[:, 0] - ptop[:, 1]) < 1e-5
    assert np.all((i1 == pidx) | near_tie)
    # plain TF32 (one product) would miss the 1e-5 tolerance by far
    plain_tf32 = _top2_np(_tf32_rna(a) @ _tf32_rna(b).T, vb)[0]
    assert np.abs(plain_tf32 - r1).max() > 1e-5


@pytest.mark.parametrize("n", [1, 5, 777, 6144, 20000])
@pytest.mark.parametrize("m", [1, 5, 777, 6144, 20000])
def test_launch_plan(n, m):
    for sms in (114, 132):                        # H100 PCIe, H100 SXM
        plan = k2._launch_plan(n, m, 128, sms)
        p, cps = plan["splits"], plan["cols_per_split"]
        assert p >= 1 and cps % k2.BLOCK_COLS == 0
        assert (p - 1) * cps < m <= p * cps        # no empty split, all covered
        assert plan["grid"] == (-(-n // k2.BLOCK_ROWS), p)
        assert plan["blocks"] == plan["grid"][0] * p
        assert plan["scratch_rows"] == (p * n if p > 1 else 0)
        if n == m == 6144:
            assert plan["blocks"] >= sms

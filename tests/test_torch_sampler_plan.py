"""K4 and K5's launch plan and the premise of their sparse sums, on the CPU.

The kernels (`cusift_tpu_torch/csrc/sampler.cu`) run only on the card
(`tests/test_torch_cuda.py`); here `_launch_plan` is checked for every
shape the batched fused path launches and for edge shapes, and numpy checks
the claim the kernels rest on: in f32, summing only the terms whose soft
bin weight and spatial weight are non-zero, in ascending sample order,
gives the same bits as the dense sequential sum with the same term
expression (K4 fma(wgt, soft, acc); K5 fma(wsp, soft * wgt, acc)).
"""

import numpy as np
import pytest

from cusift_tpu.ops.describe import _spatial_weights as jax_spatial_weights
from cusift_tpu_torch.kernels import sampler as k
from cusift_tpu_torch.ops.describe import _spatial_weights

ORI_SLOTS = (3072, 1536, 384, 96, 32)      # the batch's K4 slots per octave
DESC_SLOTS = (3840, 1920, 480, 120, 40)    # and K5's (x 1.25)
F32 = np.float32


def _check_plan(plan, n, s, cells):
    assert 1 <= plan["slots"] and plan["blocks"] * plan["slots"] >= n
    assert (plan["blocks"] - 1) * plan["slots"] < n
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= k.MAX_THREADS
    assert 1 <= plan["chunk"] <= s and plan["chunks"] * plan["chunk"] >= s
    assert (plan["chunks"] - 1) * plan["chunk"] < s
    assert plan["smem_bytes"] <= k.SMEM_BUDGET < 227 * 1024
    words = 4 * plan["slots"] * plan["chunk"]          # a 16-byte record per sample
    if cells:                                          # lists at an odd pitch, lengths
        words += 2 * cells * (plan["chunk"] | 1) + cells
    assert plan["smem_bytes"] == 4 * words


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("octave", range(5))
def test_plan_on_the_batch_path(sms, octave):
    """K4 (nb 36) and K5 (8 bins x 16 cells) at each octave of the batch:
    one chunk of 144 samples; 3 slots per block where there are slots
    enough, one where there are fewer than 2 per SM; 256 threads where the
    launch fills the card's resident threads, else a thread per sample."""
    for n, cells in ((ORI_SLOTS[octave], None), (DESC_SLOTS[octave], 16)):
        p = k._launch_plan(n, 144, cells, sms)
        _check_plan(p, n, 144, cells)
        assert p["chunks"] == 1
        assert p["slots"] == min(3, max(1, n // sms))
        if n * 144 >= sms * 2048:
            assert p["threads"] == 256
        else:
            assert p["threads"] == -(-p["slots"] * 144 // 32) * 32
        if octave >= 3:
            assert p["slots"] == 1 and p["threads"] == 160
    if octave == 0:          # both fill the card
        assert k._launch_plan(ORI_SLOTS[0], 144, None, sms)["threads"] == 256


@pytest.mark.parametrize("n,s,cells", [
    (1, 144, None), (1, 144, 16), (1, 4096, None), (1, 4096, 16), (3073, 4096, None),
    (5000, 1000, 16), (10, 9, None), (10, 9, 1), (700, 144, None), (50, 144, 1000),
    (7, 3, 16), (100000, 144, 16)])
def test_plan_edge_shapes(n, s, cells):
    """N = 1, S up to MAX_SAMPLES (chunked), one cell and 1000 cells, fewer
    samples than a warp, a launch far larger than the card."""
    plan = k._launch_plan(n, s, cells, 132)
    _check_plan(plan, n, s, cells)
    if s == 4096:
        assert plan["chunks"] > 1


def test_plan_rejects_what_cannot_launch():
    with pytest.raises(ValueError):
        k._launch_plan(0, 144, None, 132)
    with pytest.raises(ValueError):
        k._launch_plan(10, 144, 20000, 132)      # the lists alone overflow 48 KB


# --- the premise of the sparse sums, in numpy f32 --------------------------

def _soft_bin(f, b, nb):
    """csrc/sampler.cu:soft_bin in f32."""
    d = np.abs(f - F32(b))
    d = np.fmin(d, F32(nb) - d)
    return np.fmax(F32(0), F32(1) - d)


def _lower_bin(f, nb):
    """csrc/sampler.cu:lower_bin."""
    fl = np.floor(f)
    ok = (fl >= -1) & (fl < nb)
    return np.where(ok, (np.where(ok, fl, 0).astype(np.int64) + nb) % nb, 0)


def _fma(a, b, c):
    """f32 fma through f64: the product is exact; the same function serves
    the dense and the sparse sum, and with b or a zero it returns c."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _fbins(rng, n, s, nb):
    """Fractional bins as the kernels make them (fmod_pos of the angle,
    with and without the fused multiply-add), plus the edge values: 0, each
    integer bin, nb itself, one ulp under nb, -1 ulp, and NaN."""
    ang = (rng.uniform(-np.pi, 3 * np.pi, (n, s))).astype(F32)
    x = (ang / F32(2 * np.pi) * F32(nb)).astype(F32)
    q = np.floor(x / F32(nb))
    f = np.where(rng.random((n, s)) < 0.5, x - F32(nb) * q,
                 (x.astype(np.float64) - nb * q.astype(np.float64)).astype(F32))
    edges = np.array([0.0, nb, np.nextafter(F32(nb), F32(0)), -np.nextafter(F32(0), F32(1)),
                      -1e-7, np.nan, *range(nb), *(np.arange(nb) + F32(0.5))], F32)
    pick = rng.random((n, s)) < 0.3
    f[pick] = edges[rng.integers(0, len(edges), int(pick.sum()))]
    return f.astype(F32)


@pytest.mark.parametrize("nb", [36, 8, 1, 2])
def test_soft_bins_are_zero_off_lo_and_lo_plus_one(nb):
    """For every fractional bin the kernels can make, soft_bin is exactly 0
    on every bin but lo and lo + 1 mod nb, which the kernels compute."""
    f = _fbins(np.random.default_rng(nb), 64, 144, nb).ravel()
    lo = _lower_bin(f, nb)
    hi = (lo + 1) % nb
    for b in range(nb):
        soft = _soft_bin(f, b, nb)
        off = (lo != b) & (hi != b)
        assert not soft[off].any()
        np.testing.assert_array_equal(soft[lo == b], _soft_bin(f[lo == b], lo[lo == b], nb))


def test_descriptor_spatial_weights_are_sparse():
    """The descriptor's w_spatial (g = 12, d = 4): 324 non-zeros of 2304,
    16 to 25 per cell; the port's copy equals the reference's."""
    w = _spatial_weights(12, 4)[1]
    np.testing.assert_array_equal(w, np.asarray(jax_spatial_weights(12, 4)[1]))
    per_cell = (w != 0).sum(0)
    assert w.shape == (144, 16) and int(per_cell.sum()) == 324
    assert per_cell.min() == 16 and per_cell.max() == 25


def _dense_and_sparse(fb, wgt, wsp, nb, desc):
    """The dense sequential sum over every (sample, bin) term and the
    kernels' sum over the kept terms only, both [n, nb, cells] (K4: cells 1)."""
    n, s = fb.shape
    cells = wsp.shape[1]
    dense = np.zeros((n, nb, cells), F32)
    for si in range(s):
        for b in range(nb):
            soft = _soft_bin(fb[:, si], b, nb)
            if desc:   # acc += wsp * (soft * wgt)
                term = (soft * wgt[:, si]).astype(F32)
                dense[:, b] = _fma(np.broadcast_to(wsp[si], (n, cells)), term[:, None],
                                   dense[:, b])
            else:      # acc += wgt * soft
                dense[:, b, 0] = _fma(wgt[:, si], soft, dense[:, b, 0])
    lo = _lower_bin(fb, nb)
    hi = (lo + 1) % nb
    w0 = _soft_bin(fb, lo, nb)
    w1 = _soft_bin(fb, hi, nb)
    if desc:
        w0, w1 = (w0 * wgt).astype(F32), (w1 * wgt).astype(F32)
    sparse = np.zeros_like(dense)
    rows = np.arange(n)
    for c in range(cells):
        for si in np.flatnonzero(wsp[:, c]):       # the cell's list, ascending
            for b in range(nb):
                below = (b - 1) % nb
                take0 = lo[:, si] == b
                take1 = ~take0 & (lo[:, si] == below)
                a = np.full(n, wsp[si, c], F32) if desc else wgt[:, si]
                cur = sparse[rows, b, c]
                cur = np.where(take0, _fma(a, w0[:, si], cur), cur)
                cur = np.where(take1, _fma(a, w1[:, si], cur), cur)
                sparse[rows, b, c] = cur
    return dense, sparse


@pytest.mark.parametrize("which", ["k4_nb36", "k4_nb2", "k5_descriptor", "k5_zero_column"])
def test_sparse_sum_is_the_dense_sum_bit_for_bit(which):
    """On random and edge fractional bins (NaN included, whose weights are
    0), with sample weights that are 0 for some samples (out of the image),
    the kept-terms sum equals the dense sequential sum bit for bit."""
    rng = np.random.default_rng(len(which))
    desc = which.startswith("k5")
    nb = 8 if desc else int(which.split("nb")[1])
    n, s = 24, 144
    fb = _fbins(rng, n, s, nb)
    wgt = (rng.uniform(0, 3, (n, s)) * (rng.random((n, s)) > 0.1)).astype(F32)
    if desc:
        wsp = _spatial_weights(12, 4)[1].copy()
        if which == "k5_zero_column":
            wsp[:, 3] = 0.0
    else:
        wsp = np.ones((s, 1), F32)
    dense, sparse = _dense_and_sparse(fb, wgt, wsp, nb, desc)
    assert np.isfinite(dense).all() and dense.any()
    np.testing.assert_array_equal(dense.view(np.int32), sparse.view(np.int32))

"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here is marked `cuda` and skips where torch sees no CUDA
device.  The file imports no jax, so on a machine with a GPU and no jax it
runs on its own:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest

Tolerances: K1 and K6 atol 1e-5 on in-image samples (float32, same
formula, FMA contraction only), and over a batch of frames each frame
equal bit for bit to its own launch; `extract_batch` equals per-frame
`extract` exactly; K2 atol 1e-5 on the scores (float32 dot
products of unit vectors in another summation order), and the index may
differ only where the plain top-2 is a near tie; K3 atol 1e-5 on levels
and DoG (float32 sums of another order), score masks equal on >= 99.99% of
pixels; K4 and K5 1e-4 of the largest histogram value (sums over the
samples in another order, atan2f against torch's atan2), and their reruns
bit-identical.  The RGB-D paths on the card: `align_rgbd_pair` within
0.01 (R) and 0.01 m (t) of ground truth, and a short `Slam` run whose
fused and split events agree within 1e-3 and whose deferred and eager
events agree bit for bit.  Chunked tracking: a chunk step's rows equal the
sequential steps' bit for bit, with one K2 launch a chunk (two on the
stereo chunk) and one a window BA association; a batched K2 launch equals
its frames' single launches word for word at P = 1 and P > 1;
`device_chunks` delivers `device_frames`' tensors.  Stereo: `_extract_stereo_points` on the card against the CPU,
admissible counts within 1%, depths within 1e-4 relative.  Mono VO:
`pair_step` on the card against the CPU on the same frame-A features,
with the same RANSAC samples (each device's generator is its own, so the
samples are drawn on the CPU and fed to both): the same inliers, R within
1e-3, t within 1e-2 (the float32 IRLS conditioning of
tests/test_torch_odometry_samples.py); `find_essential` and `find_pnp` on the
card at tests/test_essential.py's and tests/test_pnp.py's bars; the Sim(3)
`optimize` on the card within 1e-3 relative of the CPU's cost; a short
`MonoVO` run on the card tracking every pair.  Segment sums
(`kernels/segment.py`): the kernel equal bit for bit to the CPU's
`index_add_` on the same inputs at each user's shapes, and reruns of BA
off the grid, the pose graph's CG, the Sim(3) CG and `localize_step`'s
refinement bit-identical; a short map-anchored `MonoVO` run on the card
at tests/test_monomap.py's bars.  The RANSAC homography kernels
(`kernels/homography.py`) against the plain stages of ops/ransac.py on the
card, on the same samples: hypotheses within the float64 DLT bound of
tests/test_torch_twoview.py, counts equal on >= 99.9% of hypotheses (the
kernels sum as the plain version does on the card, so they are most often
equal bit for bit), the same winner, inliers and count, and the IRLS's h
within 1e-4 of max |H| (its sums over all rows take another order than
cuBLAS's); `find_homography` at most 12 device operations a call.
"""

import numpy as np
import pytest
import torch

from cusift_tpu_torch import SiftConfig
from cusift_tpu_torch.kernels import kernel_counts
from cusift_tpu_torch.kernels import matcher as k2
from cusift_tpu_torch.kernels import octave as k3
from cusift_tpu_torch.kernels import sampler as k1
from cusift_tpu_torch.ops.gaussian import blur

pytestmark = pytest.mark.cuda


def launches(kernel: str) -> int:
    """This process's launches of one kernel wrapper so far."""
    return kernel_counts()[kernel]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda", 0)


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("shape", [(3, 240, 320, 1000, 144), (2, 24, 40, 7, 36),
                                   (4, 2, 2, 5, 9)])
def test_sampler_kernel_matches_plain(dev, shape):
    L, H, W, N, S = shape
    rng = np.random.default_rng(1)
    gauss = torch.from_numpy(rng.normal(size=(L, H, W)).astype(np.float32)).to(dev)
    lvl = torch.from_numpy(rng.integers(-1, L + 1, N).astype(np.int32)).to(dev)
    ys = torch.from_numpy(rng.uniform(-3, H + 2, (N, S)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.uniform(-3, W + 2, (N, S)).astype(np.float32)).to(dev)
    before = launches("sampler")
    dx, dy, inb = k1.sample_grad_patches(gauss, lvl, ys, xs)
    assert launches("sampler") == before + 1
    rdx, rdy, rinb = k1.sample_grad_patches_plain(gauss, lvl, ys, xs)
    torch.cuda.synchronize()
    assert torch.equal(inb, rinb)
    torch.testing.assert_close(dx[rinb], rdx[rinb], atol=1e-5, rtol=0)
    torch.testing.assert_close(dy[rinb], rdy[rinb], atol=1e-5, rtol=0)


def _k1_case(case, rng, dev):
    """(gauss, lvl, ys, xs) of one K1 card case."""
    import chip_smoke

    L, H, W, N, S = 3, 240, 320, 301, 144
    if case in ("descriptor", "orientation"):
        lvl, ys, xs = chip_smoke.path_points(rng, dev, case, L, H, W)
        gauss = torch.from_numpy(rng.normal(size=(L, H, W)).astype(np.float32)).to(dev)
        return gauss, lvl, ys, xs
    L, H, W, N, S = {"n1": (L, H, W, 1, S), "ragged": (L, H, W, 1001, S),
                     "odd_width": (3, 200, 131, N, S), "h2": (2, 2, 64, 40, S),
                     "w2": (2, 64, 2, 40, S), "s9": (L, H, W, 77, 9),
                     "s1000": (L, H, W, 7, 1000), "s3000": (L, H, W, 5, 3000)}.get(
                         case, (L, H, W, N, S))
    gauss, lvl, ys, xs = _points(rng, dev, L, H, W, N, S, 20.0)
    if case == "unaligned":            # a stack 4 bytes off 16
        buf = torch.empty(L * H * W + 1, device=dev)
        buf[1:] = gauss.reshape(-1)
        gauss = buf[1:].view(L, H, W)
    if case == "wide":                 # every third slot spread over 300 px
        ys[::3] += torch.from_numpy(rng.uniform(-150, 150, ys[::3].shape)
                                    .astype(np.float32)).to(dev)
    if case == "nan":
        ys[5:9, ::3] = float("nan")
        xs[9:13, ::4] = float("inf")
        ys[13:17, ::5] = -float("inf")
        ys[17] = float("nan")
    return gauss, lvl, ys, xs


@pytest.mark.parametrize("case", ["wide", "descriptor", "orientation", "n1", "ragged",
                                  "odd_width", "unaligned", "nan", "h2", "w2", "s9",
                                  "s1000", "s3000"])
def test_sampler_kernel_cases(dev, case):
    """K1 against its plain version (inb equal, atol 1e-5 on in-image
    samples) at the path's descriptor and orientation geometries, N = 1 and
    a ragged last block, an odd width, an unaligned stack, NaN and inf
    points, h = 2, w = 2, widely spread slots, and S under a warp and over
    a block's threads; reruns are bit-identical."""
    rng = np.random.default_rng(15)
    gauss, lvl, ys, xs = _k1_case(case, rng, dev)
    before = launches("sampler")
    out = k1.sample_grad_patches(gauss, lvl, ys, xs)
    assert launches("sampler") == before + 1
    rdx, rdy, rinb = k1.sample_grad_patches_plain(gauss, lvl, ys, xs)
    torch.cuda.synchronize()
    assert torch.equal(out[2], rinb)
    torch.testing.assert_close(out[0][rinb], rdx[rinb], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1][rinb], rdy[rinb], atol=1e-5, rtol=0)
    again = k1.sample_grad_patches(gauss, lvl, ys, xs)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("n,m,d", [(1000, 777, 128), (33, 6144, 128), (5, 3, 64),
                                   (64, 64, 100)])
def test_matcher_kernel_matches_plain(dev, n, m, d):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(_unit(rng, n, d)).to(dev)
    b = torch.from_numpy(_unit(rng, m, d)).to(dev)
    vb = torch.from_numpy(rng.random(m) > 0.2).to(dev)
    before = launches("matcher")
    top, idx = k2.top2(a, b, vb)
    assert launches("matcher") == before + 1
    rtop, ridx = k2.top2_plain(a, b, vb)
    torch.cuda.synchronize()
    fin = torch.isfinite(rtop)
    assert torch.equal(fin, torch.isfinite(top))
    torch.testing.assert_close(top[fin], rtop[fin], atol=1e-5, rtol=0)
    near_tie = (rtop[:, 0] - rtop[:, 1]) < 1e-5
    assert bool(((idx == ridx) | near_tie).all())


def test_matcher_kernel_edge_rows(dev):
    """All-invalid B, a single valid candidate, and a duplicated best."""
    rng = np.random.default_rng(3)
    a = _unit(rng, 40)
    b = _unit(rng, 50)
    b[30] = b[20]
    a[0] = b[20]
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    top, idx = k2.top2(ta, tb, torch.zeros(50, dtype=torch.bool, device=dev))
    assert bool(torch.isneginf(top).all()) and not bool(idx.any())
    one = torch.zeros(50, dtype=torch.bool, device=dev)
    one[7] = True
    top, idx = k2.top2(ta, tb, one)
    assert bool((idx == 7).all()) and bool(torch.isneginf(top[:, 1]).all())
    top, idx = k2.top2(ta, tb, torch.ones(50, dtype=torch.bool, device=dev))
    assert int(idx[0]) == 20 and float(top[0, 0]) == float(top[0, 1])


def _check_top2(top, idx, rtop, ridx):
    fin = torch.isfinite(rtop)
    assert torch.equal(fin, torch.isfinite(top))
    assert torch.equal(top[~fin], rtop[~fin])
    torch.testing.assert_close(top[fin], rtop[fin], atol=1e-5, rtol=0)
    near_tie = (rtop[:, 0] - rtop[:, 1]) < 1e-5
    assert bool(((idx == ridx) | near_tie).all())


@pytest.mark.parametrize("n,m,d", [(6144, 40, 128), (1, 6144, 128), (1000, 6144, 100),
                                   (300, 20000, 128)])
def test_matcher_kernel_split_plans(dev, n, m, d):
    """M under one column split, N = 1 (many splits), D = 100 and a long
    scan, each against the plain version; two runs are bit-identical."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(_unit(rng, n, d)).to(dev)
    b = torch.from_numpy(_unit(rng, m, d)).to(dev)
    vb = torch.from_numpy(rng.random(m) > 0.2).to(dev)
    before = launches("matcher")
    top, idx = k2.top2(a, b, vb)
    assert launches("matcher") == before + 1
    _check_top2(top, idx, *k2.top2_plain(a, b, vb))
    top2, idx2 = k2.top2(a, b, vb)
    assert torch.equal(top, top2) and torch.equal(idx, idx2)


def test_matcher_kernel_tie_across_splits(dev):
    """A best score duplicated in the first and the last column split:
    i1 is the lower index and s2 equals s1."""
    n, m = 300, 6144
    plan = k2._launch_plan(n, m, 128, k2._sm_count(dev.index))
    assert plan["splits"] > 1
    rng = np.random.default_rng(9)
    a, b = _unit(rng, n), _unit(rng, m)
    lo, hi = 5, m - 3
    assert lo < plan["cols_per_split"] <= (plan["splits"] - 1) * plan["cols_per_split"] <= hi
    b[hi] = b[lo]
    a[0] = b[lo]
    a[1] = b[lo]
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    vb = torch.ones(m, dtype=torch.bool, device=dev)
    top, idx = k2.top2(ta, tb, vb)
    assert int(idx[0]) == lo and float(top[0, 0]) == float(top[0, 1])
    vb[lo] = False
    top, idx = k2.top2(ta, tb, vb)
    assert int(idx[1]) == hi and float(top[1, 1]) < float(top[1, 0])
    _check_top2(top, idx, *k2.top2_plain(ta, tb, vb))


def _batched_operands(rng, dev, frames, n, m, shared):
    """A [frames, n] / B [frames, m] descriptor sets with B's valid mask,
    `shared` naming the side given without the frame axis (or "none")."""
    a = torch.from_numpy(np.stack([_unit(rng, n) for _ in range(frames)])).to(dev)
    b = torch.from_numpy(np.stack([_unit(rng, m) for _ in range(frames)])).to(dev)
    vb = torch.from_numpy(rng.random((frames, m)) > 0.2).to(dev)
    if shared == "a":
        a = a[0].contiguous()
    elif shared == "b":
        b, vb = b[0].contiguous(), vb[0].contiguous()
    return a, b, vb


@pytest.mark.parametrize("shared", ["b", "a", "none"])
@pytest.mark.parametrize("splits", [1, 4])
def test_matcher_kernel_batch_equals_single_launches(dev, shared, splits):
    """One batched K2 launch of 8 frames (the tracking chunk's shared
    keyframe, window BA's shared anchor, or both sides batched), at a
    forced plan of P = 1 and P = 4 column splits: each frame's (top, idx)
    equals its own single launch word for word (whatever plan that picks),
    and the plain version within K2's 1e-5 (near ties excepted)."""
    rng = np.random.default_rng(11)
    a, b, vb = _batched_operands(rng, dev, 8, 700, 1500, shared)
    before = launches("matcher")
    top, idx = k2.top2(a, b, vb, splits=splits)
    assert launches("matcher") == before + 1
    assert top.shape == (8, 700, 2) and idx.shape == (8, 700)
    for f in range(8):
        one = k2.top2(a if shared == "a" else a[f], b if shared == "b" else b[f],
                      vb if shared == "b" else vb[f])
        assert torch.equal(top[f].view(torch.int32), one[0].view(torch.int32)), f
        assert torch.equal(idx[f], one[1]), f
    rtop, ridx = k2.top2_plain(a, b, vb)
    _check_top2(top.flatten(0, 1), idx.flatten(0, 1), rtop.flatten(0, 1), ridx.flatten(0, 1))


def test_match_batch_equals_single_calls_on_the_card(dev):
    """`match` with a batched query side against a shared side, with
    cross-check: one K2 launch each way, every field of frame b equal to
    the call on frame b alone."""
    from cusift_tpu_torch import MatchConfig
    from cusift_tpu_torch.ops.match import match

    rng = np.random.default_rng(12)
    a, b, _ = _batched_operands(rng, dev, 3, 400, 500, "b")
    va = torch.from_numpy(rng.random((3, 400)) > 0.1).to(dev)
    vb = torch.from_numpy(rng.random(500) > 0.1).to(dev)
    cfg = MatchConfig(ratio_thresh=0.95, cross_check=True)
    before = launches("matcher")
    got = match(a, va, b, vb, cfg)
    assert launches("matcher") == before + 2
    for f in range(3):
        one = match(a[f], va[f], b, vb, cfg)
        assert all(torch.equal(x[f], y) for x, y in zip(got, one)), f


def test_wrappers_reject_bad_inputs(dev):
    g = torch.zeros(2, 16, 16, device=dev)
    lvl = torch.zeros(4, dtype=torch.int32, device=dev)
    ys = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError):
        k1.sample_grad_patches(g, lvl.long(), ys, ys)          # dtype
    with pytest.raises(ValueError):
        k1.sample_grad_patches(g, lvl, ys.t().contiguous().t(), ys)  # layout
    with pytest.raises(ValueError):
        k1.sample_grad_patches(g, lvl, ys.cpu(), ys)           # device
    d = torch.zeros(4, 256, device=dev)
    with pytest.raises(ValueError):
        k2.top2(d, d, torch.ones(4, dtype=torch.bool, device=dev))  # D > 128


def _points(rng, dev, L, H, W, N, S, spread):
    """Levels, per-slot levels and sample points around random centres,
    with some slots at the borders and outside the image."""
    gauss = torch.from_numpy(rng.normal(size=(L, H, W)).astype(np.float32)).to(dev)
    lvl = torch.from_numpy(rng.integers(-1, L + 1, N).astype(np.int32)).to(dev)
    cy = rng.uniform(-10, H + 10, (N, 1))
    cx = rng.uniform(-10, W + 10, (N, 1))
    ys = cy + rng.uniform(-spread, spread, (N, S))
    xs = cx + rng.uniform(-spread, spread, (N, S))
    ys[:2, :4] = 0.0
    xs[2:4, :4] = W - 1
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return gauss, lvl, as_t(ys), as_t(xs)


def _close_rel(got, ref, rel):
    scale = ref.abs().max().clamp(min=1e-12)
    torch.testing.assert_close(got / scale, ref / scale, atol=rel, rtol=0)


@pytest.mark.parametrize("shape", [(1, 960, 1280), (3, 200, 131), (2, 64, 64)])
def test_octave_kernel_matches_plain(dev, shape):
    """K3 on one frame and on a batch (ragged tiles at 200x131)."""
    rng = np.random.default_rng(4)
    cfg = SiftConfig()
    base = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    base = blur(base, 1.2)                  # image-like smoothness
    before = launches("octave")
    got = k3.fused_octave(base, cfg)
    assert launches("octave") == before + 1
    ref = k3.fused_octave_plain(base, cfg)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    fin, rfin = torch.isfinite(got[2]), torch.isfinite(ref[2])
    assert (fin == rfin).float().mean().item() >= 0.9999
    both = fin & rfin
    torch.testing.assert_close(got[2][both], ref[2][both], atol=1e-5, rtol=0)
    singles = [k3.fused_octave(b.contiguous(), cfg) for b in base]
    for i, one in enumerate(singles):
        for a, b in zip(one, got):
            assert torch.equal(a, b[i])


@pytest.mark.parametrize("n,s", [(3072, 144), (77, 64)])
def test_ori_hist_kernel_matches_plain(dev, n, s):
    rng = np.random.default_rng(5)
    gauss, lvl, ys, xs = _points(rng, dev, 3, 240, 320, n, s, 20.0)
    wv = torch.from_numpy(rng.uniform(0, 1, (n, s)).astype(np.float32)).to(dev)
    before = launches("ori_hist")
    hist = k1.sample_ori_hist(gauss, lvl, ys, xs, wv, 36)
    assert launches("ori_hist") == before + 1
    ref = k1.sample_ori_hist_plain(gauss, lvl, ys, xs, wv, 36)
    torch.cuda.synchronize()
    _close_rel(hist, ref, 1e-4)
    assert torch.equal(hist, k1.sample_ori_hist(gauss, lvl, ys, xs, wv, 36))


@pytest.mark.parametrize("n,s", [(3840, 144), (45, 64)])
def test_desc_raw_kernel_matches_plain(dev, n, s):
    rng = np.random.default_rng(6)
    gauss, lvl, ys, xs = _points(rng, dev, 3, 240, 320, n, s, 20.0)
    wv = torch.from_numpy(rng.uniform(0, 1, (n, s)).astype(np.float32)).to(dev)
    theta = torch.from_numpy(rng.uniform(0, 2 * np.pi, n).astype(np.float32)).to(dev)
    wsp = torch.from_numpy(rng.uniform(0, 1, (s, 16)).astype(np.float32)).to(dev)
    before = launches("desc_raw")
    raw = k1.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, wsp, 8)
    assert launches("desc_raw") == before + 1 and raw.shape == (n, 8, 16)
    ref = k1.sample_desc_raw_plain(gauss, lvl, ys, xs, theta, wv, wsp, 8)
    torch.cuda.synchronize()
    _close_rel(raw, ref, 1e-4)
    assert torch.equal(raw, k1.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, wsp, 8))


def _desc_weights(kind, s, cells, rng):
    """w_spatial [s, cells]: the descriptor's own (s = 144), one with an
    all-zero column, or a random one with ~80% zeros."""
    from cusift_tpu_torch.ops.describe import _spatial_weights

    if kind == "descriptor":
        return _spatial_weights(12, 4)[1]
    w = rng.uniform(0, 1, (s, cells)).astype(np.float32)
    if kind == "zero_column":
        w[:, 5] = 0.0
    else:
        w[rng.random((s, cells)) < 0.8] = 0.0
    return w


@pytest.mark.parametrize("kind,n,s", [("descriptor", 3840, 144), ("descriptor", 1, 144),
                                      ("zero_column", 777, 144), ("sparse", 40, 1000)])
def test_desc_raw_kernel_spatial_weights(dev, kind, n, s):
    """K5 with the descriptor's own spatial weights, an all-zero column, and
    more samples than one shared-memory chunk holds; reruns bit-identical."""
    rng = np.random.default_rng(11)
    gauss, lvl, ys, xs = _points(rng, dev, 3, 240, 320, n, s, 20.0)
    wv = torch.from_numpy(rng.uniform(0, 1, (n, s)).astype(np.float32)).to(dev)
    theta = torch.from_numpy(rng.uniform(0, 2 * np.pi, n).astype(np.float32)).to(dev)
    wsp = torch.from_numpy(_desc_weights(kind, s, 16, rng)).to(dev)
    plan = k1._launch_plan(n, s, 16, k1._sm_count(dev.index))
    assert (plan["chunks"] > 1) == (s > 144)
    raw = k1.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, wsp, 8)
    ref = k1.sample_desc_raw_plain(gauss, lvl, ys, xs, theta, wv, wsp, 8)
    torch.cuda.synchronize()
    _close_rel(raw, ref, 1e-4)
    if kind == "zero_column":
        assert not bool(raw[:, :, 5].any())
    assert torch.equal(raw, k1.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, wsp, 8))


def _ragged_n(cells, s, sms, start=1000):
    """A slot count whose last block is ragged under the K4/K5 plan."""
    n = start
    while n % k1._launch_plan(n, s, cells, sms)["slots"] == 0:
        n += 1
    return n


@pytest.mark.parametrize("which", ["k4", "k5"])
def test_hist_kernels_ragged_last_block(dev, which):
    """N = 1 and an N that leaves the last block of slots part-filled,
    against the plain versions; the ragged run's slots match single-slot
    launches bit for bit."""
    sms = k1._sm_count(dev.index)
    rng = np.random.default_rng(12)
    cells = 16 if which == "k5" else None
    nb = 8 if which == "k5" else 36
    n = _ragged_n(cells, 144, sms)
    assert k1._launch_plan(n, 144, cells, sms)["slots"] > 1
    gauss, lvl, ys, xs = _points(rng, dev, 3, 240, 320, n, 144, 20.0)
    wv = torch.from_numpy(rng.uniform(0, 1, (n, 144)).astype(np.float32)).to(dev)
    theta = torch.from_numpy(rng.uniform(0, 2 * np.pi, n).astype(np.float32)).to(dev)
    wsp = torch.from_numpy(_desc_weights("descriptor", 144, 16, rng)).to(dev)

    def run(sl):
        if which == "k4":
            return k1.sample_ori_hist(gauss, lvl[sl], ys[sl], xs[sl], wv[sl], nb)
        return k1.sample_desc_raw(gauss, lvl[sl], ys[sl], xs[sl], theta[sl], wv[sl],
                                  wsp, nb)

    def plain(sl):
        if which == "k4":
            return k1.sample_ori_hist_plain(gauss, lvl[sl], ys[sl], xs[sl], wv[sl], nb)
        return k1.sample_desc_raw_plain(gauss, lvl[sl], ys[sl], xs[sl], theta[sl],
                                        wv[sl], wsp, nb)

    full = run(slice(None))
    _close_rel(full, plain(slice(None)), 1e-4)
    for i in (0, n - 1):
        one = run(slice(i, i + 1))
        _close_rel(one, plain(slice(i, i + 1)), 1e-4)
        assert torch.equal(one[0], full[i])


def _stamped_level(h=32, w=32):
    """A level whose central-difference gradient at chosen integer points is
    exactly (dx, dy): angle 0, pi, pi/2, -pi/2 and a tiny negative angle
    whose fractional bin rounds to nb after the circular fmod."""
    g = np.zeros((h, w), np.float32)
    points = []
    for (r, c), (dx, dy) in zip(((4, 4), (4, 12), (4, 20), (12, 4), (12, 12)),
                                ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0),
                                 (1.0, -1e-8))):
        g[r, c + 1], g[r, c - 1] = dx, -dx
        g[r + 1, c], g[r - 1, c] = dy, -dy
        points.append((r, c))
    return g, points


@pytest.mark.parametrize("nb", [36, 1, 2, 10, 300])
def test_ori_hist_kernel_bin_edges(dev, nb):
    """K4 where fractional bins land exactly on bin edges and at nb after
    the fmod (which weighs on bin 0 alone), for nb other than 36 too (nb =
    300 gives a thread more than one bin)."""
    g, points = _stamped_level()
    rng = np.random.default_rng(13)
    n, s = 50, 40
    pts = np.array(points, np.float32)[rng.integers(0, len(points), (n, s))]
    gauss = torch.from_numpy(np.stack([g, g[::-1].copy()])).to(dev)
    lvl = torch.zeros(n, dtype=torch.int32, device=dev)
    ys = torch.from_numpy(np.ascontiguousarray(pts[..., 0])).to(dev)
    xs = torch.from_numpy(np.ascontiguousarray(pts[..., 1])).to(dev)
    wv = torch.from_numpy(rng.uniform(0.5, 1, (n, s)).astype(np.float32)).to(dev)
    hist = k1.sample_ori_hist(gauss, lvl, ys, xs, wv, nb)
    ref = k1.sample_ori_hist_plain(gauss, lvl, ys, xs, wv, nb)
    torch.cuda.synchronize()
    _close_rel(hist, ref, 1e-4)
    assert torch.equal(hist, k1.sample_ori_hist(gauss, lvl, ys, xs, wv, nb))


def test_desc_raw_kernel_bin_edges(dev):
    """K5 with slot orientations that put the fractional bins on edges
    (theta = 0, pi/2, pi, 2 pi) and at nb after the fmod (a tiny negative
    theta), on the stamped level's exact gradients; a NaN theta and NaN
    points weigh nothing."""
    from cusift_tpu_torch.ops.describe import _spatial_weights

    g, points = _stamped_level()
    rng = np.random.default_rng(14)
    n, s = 60, 144
    pts = np.array(points, np.float32)[rng.integers(0, len(points), (n, s))]
    gauss = torch.from_numpy(g[None]).to(dev)
    lvl = torch.zeros(n, dtype=torch.int32, device=dev)
    ys = torch.from_numpy(np.ascontiguousarray(pts[..., 0])).to(dev)
    xs = torch.from_numpy(np.ascontiguousarray(pts[..., 1])).to(dev)
    ys[7, :10] = float("nan")
    thetas = np.array([0.0, np.pi / 2, np.pi, 2 * np.pi, -1e-7], np.float32)
    theta = torch.from_numpy(thetas[np.arange(n) % len(thetas)]).to(dev)
    wv = torch.from_numpy(rng.uniform(0.5, 1, (n, s)).astype(np.float32)).to(dev)
    wsp = torch.from_numpy(_spatial_weights(12, 4)[1]).to(dev)
    raw = k1.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, wsp, 8)
    ref = k1.sample_desc_raw_plain(gauss, lvl, ys, xs, theta, wv, wsp, 8)
    torch.cuda.synchronize()
    _close_rel(raw, ref, 1e-4)
    theta[3] = float("nan")
    raw = k1.sample_desc_raw(gauss, lvl, ys, xs, theta, wv, wsp, 8)
    assert not bool(raw[3].any()) and bool(torch.isfinite(raw).all())


def _sep_case(case, rng, dev):
    """(gauss, lvl, ys_rows, xs_cols) of one K6 card case."""
    import chip_smoke

    L, H, W = 3, 240, 320
    if case == "orientation":                      # the grid K6 serves on the path
        gauss = torch.from_numpy(rng.normal(size=(L, H, W)).astype(np.float32)).to(dev)
        return (gauss, *chip_smoke.orientation_rows(rng, dev, 384, L, H, W))
    n, gr, gc = {"n1": (1, 12, 12), "gr_ne_gc": (33, 5, 7), "tall": (50, 40, 3),
                 "s1": (301, 1, 1), "s600": (9, 20, 30), "ragged": (1001, 12, 12),
                 "h2": (40, 12, 12), "w2": (40, 12, 12)}.get(case, (3072, 12, 12))
    H, W = {"h2": (2, 64), "w2": (64, 2)}.get(case, (H, W))
    gauss, lvl, ys, xs = _points(rng, dev, L, H, W, n, max(gr, gc), 30.0)
    ys_rows, xs_cols = ys[:, :gr].contiguous(), xs[:, :gc].contiguous()
    if case == "border":                           # rows and columns on the borders
        ys_rows[::2, ::3] = 0.0
        ys_rows[1::2, ::3] = H - 1.0
        ys_rows[::4, 1::3] = H - 1.5
        xs_cols[1::2, ::2] = W - 1.0
        xs_cols[::4, 1::4] = 0.0
        xs_cols[::3, 3] = W - 2.0
    if case == "outside":                          # whole grids off the image
        ys_rows[:100] -= H + 40.0
        xs_cols[100:200] += W + 40.0
        ys_rows[200:300] += H + 40.0
    if case == "nan":
        ys_rows[5:9, ::3] = float("nan")
        ys_rows[9] = float("nan")
        xs_cols[13:17, ::4] = float("nan")
        xs_cols[17:21, ::5] = float("inf")
        ys_rows[21:25, ::2] = -float("inf")
    return gauss, lvl, ys_rows, xs_cols


@pytest.mark.parametrize("case", ["random", "orientation", "border", "outside", "nan",
                                  "gr_ne_gc", "tall", "n1", "s1", "s600", "ragged", "h2",
                                  "w2"])
def test_sep_sampler_kernel_matches_plain(dev, case):
    """K6 against its plain version (inb equal, atol 1e-5 on in-image
    samples) at random rows and columns, the orientation grid of the
    separable path, rows and columns on the borders, grids wholly outside
    the image, NaN and inf rows and columns, GR != GC and tall grids, one
    sample a slot, 600 samples a slot, N = 1 and a ragged last block, h = 2
    and w = 2; reruns are bit-identical."""
    rng = np.random.default_rng(7)
    gauss, lvl, ys_rows, xs_cols = _sep_case(case, rng, dev)
    n, gr, gc = ys_rows.shape + xs_cols.shape[1:]
    before = launches("sep")
    out = k1.sample_grad_patches_sep(gauss, lvl, ys_rows, xs_cols)
    assert launches("sep") == before + 1 and out[0].shape == (n, gr * gc)
    rdx, rdy, rinb = k1.sample_grad_patches_sep_plain(gauss, lvl, ys_rows, xs_cols)
    torch.cuda.synchronize()
    assert torch.equal(out[2], rinb)
    torch.testing.assert_close(out[0][rinb], rdx[rinb], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1][rinb], rdy[rinb], atol=1e-5, rtol=0)
    again = k1.sample_grad_patches_sep(gauss, lvl, ys_rows, xs_cols)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_sep_sampler_rejects_what_it_cannot_index(dev):
    """K6 indexes in 32 bits: 2^16 slots of 182 x 182 samples are refused."""
    g = torch.zeros(1, 8, 8, device=dev)
    n = 2**16
    lvl = torch.zeros(n, dtype=torch.int32, device=dev)
    grid = torch.zeros(n, 182, device=dev)
    with pytest.raises(ValueError, match="2\\^31"):
        k1.sample_grad_patches_sep(g, lvl, grid, grid)


def _batched_inputs(rng, dev, B=3, L=3, H=120, W=160, N=50, S=144):
    """[B, L, H, W] levels and [B, N, ...] slots, levels in [-1, L]."""
    as_t = lambda a, dt=np.float32: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    cy, cx = rng.uniform(-5, H + 5, (B, N, 1)), rng.uniform(-5, W + 5, (B, N, 1))
    return dict(gauss=as_t(rng.normal(size=(B, L, H, W))),
                lvl=as_t(rng.integers(-1, L + 1, (B, N)), np.int32),
                ys=as_t(cy + rng.uniform(-12, 12, (B, N, S))),
                xs=as_t(cx + rng.uniform(-12, 12, (B, N, S))),
                wv=as_t(rng.uniform(0, 1, (B, N, S))),
                theta=as_t(rng.uniform(0, 2 * np.pi, (B, N))))


@pytest.mark.parametrize("which", ["k1", "k4", "k5", "k6"])
def test_batched_kernels_match_plain_and_frames(dev, which):
    """K1, K4, K5 and K6 over a batch of 3 frames in one launch: against
    their plain versions (K1 and K6 at 1e-5, K4 and K5 at 1e-4 of the
    largest value), and each frame bit for bit against a launch over that
    frame alone, with levels outside [0, L - 1] clipped within the frame."""
    from cusift_tpu_torch.ops.describe import _spatial_weights

    rng = np.random.default_rng(31)
    a = _batched_inputs(rng, dev)
    g, lvl, ys, xs, wv, th = (a[key] for key in ("gauss", "lvl", "ys", "xs", "wv", "theta"))
    wsp = torch.from_numpy(_spatial_weights(12, 4)[1]).to(dev)
    if which == "k6":
        ys, xs = ys[..., :12].contiguous(), xs[..., :12].contiguous()
    run, plain, count = {
        "k1": (lambda *t: k1.sample_grad_patches(*t[:4]),
               lambda *t: k1.sample_grad_patches_plain(*t[:4]), "sampler"),
        "k6": (lambda *t: k1.sample_grad_patches_sep(*t[:4]),
               lambda *t: k1.sample_grad_patches_sep_plain(*t[:4]), "sep"),
        "k4": (lambda *t: (k1.sample_ori_hist(*t[:5], 36),),
               lambda *t: (k1.sample_ori_hist_plain(*t[:5], 36),), "ori_hist"),
        "k5": (lambda *t: (k1.sample_desc_raw(*t[:4], t[5], t[4], wsp, 8),),
               lambda *t: (k1.sample_desc_raw_plain(*t[:4], t[5], t[4], wsp, 8),),
               "desc_raw"),
    }[which]
    args = (g, lvl, ys, xs, wv, th)
    before = launches(count)
    out = run(*args)
    assert launches(count) == before + 1
    ref = plain(*args)
    torch.cuda.synchronize()
    if len(out) == 3:
        assert torch.equal(out[2], ref[2])
        for o, r in zip(out[:2], ref[:2]):
            torch.testing.assert_close(o[ref[2]], r[ref[2]], atol=1e-5, rtol=0)
    else:
        _close_rel(out[0], ref[0], 1e-4)
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    for f in range(g.shape[0]):
        one = run(*(t[f] for t in args))
        for o, r in zip(out, one):
            assert torch.equal(bits(o[f]), bits(r)), (which, f)


def test_extract_batch_matches_extract_per_frame(dev):
    """The default (chain) path's extract_batch of a [4, 240, 320] batch,
    one batched program, equals extract of each frame on the card, every
    field slot by slot, though cuDNN, the sorts and the kernels get the
    whole batch."""
    from cusift_tpu_torch.data.synthetic import textured_image
    from cusift_tpu_torch.models.sift import extract, extract_batch

    cfg = SiftConfig(max_kpts=512, max_kpts_per_octave=256)
    imgs = torch.from_numpy(np.stack([textured_image(240, 320, seed=s)
                                      for s in range(4)])).to(dev)
    batch = extract_batch(imgs, cfg)
    assert int(batch.valid.sum()) > 100
    for i in range(imgs.shape[0]):
        one = extract(imgs[i], cfg)
        for name, a, b in zip(one._fields, batch, one):
            assert torch.equal(a[i], b), (i, name)


def _big_radius_sigma0(r=32):
    """A sigma0 whose widest level blur has tap radius r (S = 3)."""
    for sigma0 in np.arange(2.5, 2.8, 0.01):
        cfg = SiftConfig(sigma0=float(sigma0))
        if k3._tap_table(tuple(k3.level_sigmas(cfg)))[2] == r:
            return cfg
    raise AssertionError(f"no sigma0 gives radius {r}")


@pytest.mark.parametrize("case", ["batch8_480x640", "ragged_70x200", "levels8", "radius32"])
def test_octave_kernel_plans(dev, case):
    """K3 at the batch's octave-1 shape, a ragged strip, 8 levels and the
    largest radius: atol 1e-5, masks on >= 99.99%, batch == singles."""
    shape, cfg = {
        "batch8_480x640": ((8, 480, 640), SiftConfig()),
        "ragged_70x200": ((2, 70, 200), SiftConfig()),
        "levels8": ((2, 160, 200), SiftConfig(scales_per_octave=6)),
        "radius32": ((2, 96, 136), _big_radius_sigma0()),
    }[case]
    rng = np.random.default_rng(10)
    base = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    base = blur(base, 1.2)
    got = k3.fused_octave(base, cfg)
    ref = k3.fused_octave_plain(base, cfg)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    fin, rfin = torch.isfinite(got[2]), torch.isfinite(ref[2])
    assert (fin == rfin).float().mean().item() >= 0.9999
    both = fin & rfin
    torch.testing.assert_close(got[2][both], ref[2][both], atol=1e-5, rtol=0)
    for i in range(shape[0]):
        one = k3.fused_octave(base[i].contiguous(), cfg)
        for a, b in zip(one, got):
            assert torch.equal(a, b[i])


def test_align_rgbd_pair_on_the_card(dev):
    """align_rgbd_pair at chip_smoke.py phase 13's shape (frames 0 and 2 of
    the 480x640 planar sequence, 2048 keypoints) through K1 and K2: R
    within 0.01 and t within 0.01 m of ground truth."""
    from cusift_tpu_torch import MatchConfig, RansacConfig
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
    from cusift_tpu_torch.models.twoview import align_rgbd_pair

    seq = planar_rgbd_sequence(8, 480, 640, seed=2, motion_scale=0.6)
    before = (launches("sampler"), launches("matcher"))
    res = align_rgbd_pair(seq.images[0], seq.depths[0], seq.images[2], seq.depths[2],
                          seq.intr, SiftConfig(max_kpts=2048, max_kpts_per_octave=1024),
                          MatchConfig(), RansacConfig(inlier_thresh_3d=0.03), device=dev)
    assert launches("sampler") > before[0] and launches("matcher") > before[1]
    assert res.rigid.r.device.type == "cuda" and bool(res.rigid.ok)
    r_true = seq.poses_r[2] @ seq.poses_r[0].T
    t_true = seq.poses_t[2] - r_true @ seq.poses_t[0]
    assert np.abs(res.rigid.r.cpu().numpy() - r_true).max() < 0.01
    assert np.linalg.norm(res.rigid.t.cpu().numpy() - t_true) < 0.01


def _card_slam_run(dev, **kw):
    """A 12-frame Slam run on the card at the CPU tests' small shapes."""
    from cusift_tpu_torch import PoseGraphConfig, RansacConfig, SlamConfig
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
    from cusift_tpu_torch.models.slam import Slam

    seq = planar_rgbd_sequence(12, 240, 320, motion_scale=0.9, seed=5)
    cfg = dict(max_keyframes=32, kf_min_inliers=220, kf_max_translation=0.06,
               kf_max_rotation=0.06, loop_temporal_gap=4, loop_min_score=0.05,
               loop_min_inliers=25)
    slam = Slam(seq.intr, sift_cfg=SiftConfig(max_kpts=384, max_kpts_per_octave=192,
                                              num_octaves=3),
                ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                slam_cfg=SlamConfig(**cfg, **kw),
                pg_cfg=PoseGraphConfig(solver="dense"), device=dev)
    slam.run(zip(seq.images, seq.depths))
    assert slam.state.kf_desc.device.type == "cuda"
    return seq, slam


def test_slam_fused_and_split_agree_on_the_card(dev):
    """Fused and split events on the card: the same keyframes, closures
    and edges, trajectories within 1e-3."""
    seq, sf = _card_slam_run(dev, fused_events=True)
    _, ss = _card_slam_run(dev, fused_events=False)
    assert sf.state.n_kf == ss.state.n_kf >= 8
    assert sf.state.n_closures == ss.state.n_closures
    assert sf.state.edge_i == ss.state.edge_i
    for a, b in zip(sf.trajectory(), ss.trajectory()):
        np.testing.assert_allclose(a, b, atol=1e-3)
    assert sf.ate(seq.poses_r, seq.poses_t) < 0.05


def test_slam_deferred_events_match_eager_on_the_card(dev):
    """Deferred and eager events on the card give bit-identical
    trajectories and metric records: every sum on the path is
    deterministic (no atomics), and the fetch time changes nothing."""
    _, sd = _card_slam_run(dev, defer_events=True)
    _, se = _card_slam_run(dev, defer_events=False)
    assert sd.state.n_closures == se.state.n_closures >= 1
    assert sd.state.edge_i == se.state.edge_i
    assert [r["loop"] for r in sd.metrics] == [r["loop"] for r in se.metrics]
    for a, b in zip(sd.trajectory(), se.trajectory()):
        np.testing.assert_array_equal(a, b)


def test_chunk_rows_equal_frame_steps_on_the_card(dev):
    """A chunk step of 4 frames (240x320) on the card: its packed rows and
    points equal 4 sequential `_frame_step` calls with the same generator
    seeds, bit for bit (one extract_batch over the chunk equals extract of
    each frame)."""
    from cusift_tpu_torch import SlamConfig
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
    from cusift_tpu_torch.models.slam import Slam, _chunk_step, _frame_step

    seq = planar_rgbd_sequence(6, 240, 320, motion_scale=0.5, seed=4)
    cfg = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
    slam = Slam(seq.intr, sift_cfg=cfg, slam_cfg=SlamConfig(max_keyframes=8), device=dev)
    slam.process_frame(seq.images[0], seq.depths[0])
    _, kd, kv, kp = slam._ref_cache
    chunk = torch.from_numpy(np.stack([np.stack([seq.images[i], seq.depths[i]])
                                       for i in range(1, 5)])).to(dev)
    before = (launches("sampler"), launches("matcher"))
    _, pts, rows = _chunk_step(chunk, slam.intr, kd, kv, kp, cfg, slam.match_cfg,
                               slam.ransac_cfg, slam._next_keys(4))
    # one extract_batch over the chunk: K1 once an octave and a use
    assert launches("sampler") - before[0] == 2 * cfg.num_octaves_for(240, 320)
    assert launches("matcher") - before[1] == 1
    slam._key_ctr -= 4
    for i in range(4):
        _, p, row = _frame_step(chunk[i, 0], chunk[i, 1], slam.intr, kd, kv, kp, cfg,
                                slam.match_cfg, slam.ransac_cfg, slam._next_key())
        assert torch.equal(row, rows[i]), (i, (row - rows[i]).abs().max().item())
        assert torch.equal(p, pts[i])
    assert bool((rows[:, 1] == 1).all())


def test_stereo_chunk_rows_equal_frame_steps_on_the_card(dev):
    """A stereo chunk of 3 pairs (240x320) on the card: two K2 launches
    (the batched left-right match and the batched tracking match), and
    its rows and points equal 3 sequential `_stereo_frame_step` calls with
    the same generator seeds, bit for bit."""
    from cusift_tpu_torch import SlamConfig
    from cusift_tpu_torch.data.synthetic import two_plane_stereo_sequence
    from cusift_tpu_torch.models.stereo import StereoSlam, _stereo_chunk_step

    seq = two_plane_stereo_sequence(5, 240, 320, seed=4, motion_scale=0.7, amplitude=2.0)
    cfg = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
    slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=cfg,
                      slam_cfg=SlamConfig(max_keyframes=8), device=dev)
    slam.process_frame(seq.images_l[0], seq.images_r[0])
    _, kd, kv, kp = slam._ref_cache
    chunk = torch.from_numpy(np.stack([np.stack([seq.images_l[i], seq.images_r[i]])
                                       for i in (1, 2, 3)])).to(dev)
    before = (launches("sampler"), launches("matcher"))
    _, pts, rows = _stereo_chunk_step(chunk, slam.intr, slam.baseline, kd, kv, kp, cfg,
                                      slam.match_cfg, slam.ransac_cfg, slam._next_keys(3))
    assert launches("sampler") - before[0] == 2 * cfg.num_octaves_for(240, 320)
    assert launches("matcher") - before[1] == 2
    slam._key_ctr -= 3
    for i in range(3):
        _, p, row = slam._sense_step(chunk[i, 0], chunk[i, 1], kd, kv, kp, slam._next_key())
        assert torch.equal(row, rows[i]), (i, (row - rows[i]).abs().max().item())
        assert torch.equal(p, pts[i])
    assert bool((rows[:, 1] == 1).all())


def test_window_association_is_one_launch_on_the_card(dev):
    """`build_window_problem` on a 5-keyframe window of a 240x320 orbit:
    one K2 launch for the window (the anchor's descriptors shared), each
    keyframe's match equal to its own `match` call, and observations
    kept."""
    from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
    from cusift_tpu_torch.models.local_ba import build_window_problem
    from cusift_tpu_torch.models.slam import _extract_with_points
    from cusift_tpu_torch.ops.match import match

    # tests/test_torch_local_ba.py's window: detail adds shared landmarks
    seq = planar_rgbd_sequence(5, 240, 320, seed=5, motion_scale=0.8, detail=0.3)
    cfg = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
    intr = torch.from_numpy(seq.intr).to(dev)
    feats = [_extract_with_points(torch.from_numpy(seq.images[i]).to(dev),
                                  torch.from_numpy(seq.depths[i]).to(dev), intr, cfg)
             for i in range(5)]
    kd = torch.stack([f.desc for f, _, _ in feats])
    kv = torch.stack([f.valid for f, _, _ in feats])
    kp = torch.stack([p for _, p, _ in feats])
    pr = torch.from_numpy(seq.poses_r[:5]).to(dev)
    pt = torch.from_numpy(seq.poses_t[:5]).to(dev)
    before = launches("matcher")
    prob = build_window_problem(kd, kv, kp, pr, pt, intr, torch.ones(5, device=dev))
    assert launches("matcher") == before + 1
    assert int((prob.w > 0).sum()) > 100
    valid_j = kv[4] & (kp[4, :, 2] > 1e-6)
    batch = match(kd[4], valid_j, kd, kv)
    for k in range(5):
        one = match(kd[4], valid_j, kd[k], kv[k])
        assert all(torch.equal(x[k], y) for x, y in zip(batch, one)), k


def test_extract_stereo_points_card_matches_cpu(dev):
    """`_extract_stereo_points` of one 240x320 pair on the card against the
    CPU run of the same pair: admissible counts within 1%, and where the
    same feature (position within 1e-3 px) is admissible on both, depths
    within 1e-4 relative."""
    from cusift_tpu_torch import MatchConfig
    from cusift_tpu_torch.data.synthetic import two_plane_stereo_sequence
    from cusift_tpu_torch.models.stereo import _extract_stereo_points

    seq = two_plane_stereo_sequence(1, 240, 320, seed=4, motion_scale=0.7, amplitude=2.0)
    cfg = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
    out = {}
    for d in (torch.device("cpu"), dev):
        args = [torch.from_numpy(a).to(d) for a in (seq.images_l[0], seq.images_r[0], seq.intr)]
        f, pts, ok = _extract_stereo_points(*args, torch.tensor(np.float32(seq.baseline),
                                                                device=d), cfg, MatchConfig())
        out[d.type] = (torch.stack([f.x, f.y], -1).cpu(), pts[:, 2].cpu(), ok.cpu())
    (xy_c, z_c, ok_c), (xy_g, z_g, ok_g) = out["cpu"], out["cuda"]
    n_c, n_g = int(ok_c.sum()), int(ok_g.sum())
    assert n_c >= 60 and abs(n_g - n_c) <= max(1, 0.01 * n_c), (n_c, n_g)
    d = torch.cdist(xy_c[ok_c].double(), xy_g[ok_g].double())
    near, j = d.min(1)
    same = near < 1e-3
    assert same.float().mean().item() >= 0.99
    zc, zg = z_c[ok_c][same], z_g[ok_g][j[same]]
    assert ((zc - zg).abs() / zc).max().item() < 1e-4


def test_device_chunks_match_device_frames_on_the_card(dev):
    """device_chunks on the card delivers the tensors device_frames does,
    chunk by chunk, the last chunk padded with its last frame."""
    from cusift_tpu_torch.utils.pipeline import device_chunks, device_frames

    rng = np.random.default_rng(3)
    frames = [(rng.random((48, 64), dtype=np.float32), rng.random((48, 64), dtype=np.float32))
              for _ in range(7)]
    singles = [f.clone() for f in device_frames(iter(frames), dev)]
    chunks = [(c.clone(), n) for c, n in device_chunks(iter(frames), 3, dev)]
    assert [n for _, n in chunks] == [3, 3, 1]
    for k, (c, _) in enumerate(chunks):
        assert c.device.type == "cuda" and c.shape == (3, 2, 48, 64)
        for i in range(3):
            assert torch.equal(c[i], singles[min(3 * k + i, 6)])


def _drawn_samples(monkeypatch):
    """Draw RANSAC samples with numpy on the CPU, for any device: each
    call maps one uniform table onto its valid set."""
    from cusift_tpu_torch.ops import essential, pnp

    table = torch.from_numpy(np.random.default_rng(17).random((1024, 12)).astype(np.float32))

    def draw(gen, valid, nhyp, k):
        cnt = torch.cumsum(valid.to(torch.int32), 0)
        m = (table[:nhyp, :k].to(valid.device) * cnt[-1].clamp(min=1)).to(torch.int32)
        return torch.searchsorted(cnt, m + 1).clamp(max=valid.shape[0] - 1)

    monkeypatch.setattr(essential, "_sample_indices", draw)
    monkeypatch.setattr(pnp, "_sample_indices", draw)


def test_pair_step_card_matches_cpu(dev, monkeypatch):
    """One 240x320 pair (tests/test_odometry.py's scene) on both devices
    from the same frame-A features and the same samples."""
    from cusift_tpu_torch import RansacConfig
    from cusift_tpu_torch.data.synthetic import two_plane_sequence
    from cusift_tpu_torch.models.odometry import pair_step
    from cusift_tpu_torch.models.sift import extract

    _drawn_samples(monkeypatch)
    seq = two_plane_sequence(n_frames=3, h=240, w=320, seed=3, motion_scale=0.6)
    cfg = SiftConfig(max_kpts=768, max_kpts_per_octave=512, num_octaves=4)
    fa = extract(torch.from_numpy(seq.images[0]), cfg)
    out = {}
    for d in (torch.device("cpu"), dev):
        before = (launches("sampler"), launches("matcher"))
        res, row = pair_step(*(a.to(d) for a in (fa.desc, fa.valid, torch.stack([fa.x, fa.y], -1),
                                                 torch.zeros(768))),
                             torch.from_numpy(seq.images[1]).to(d),
                             torch.from_numpy(seq.intr).to(d), torch.ones((), device=d), cfg,
                             ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3))
        if d.type == "cuda":
            assert launches("sampler") - before[0] == 2 * cfg.num_octaves_for(240, 320)
            assert launches("matcher") - before[1] == 1
        out[d.type] = (res, row)
    (rc, row_c), (rg, row_g) = out["cpu"], out["cuda"]
    assert row_c[15] == row_g[15] == 1.0 and abs(row_c[13] - row_g[13]) <= 1
    np.testing.assert_allclose(row_g[:9], row_c[:9], atol=1e-3)
    np.testing.assert_allclose(row_g[9:12], row_c[9:12], atol=1e-2)


def test_essential_and_pnp_on_the_card(dev):
    """find_essential and find_pnp on the card at the reference tests'
    bars (512 correspondences, 150 outliers, noise 5e-4; 256 landmarks
    with 35% outliers)."""
    from cusift_tpu_torch import RansacConfig
    from cusift_tpu_torch.ops.essential import find_essential
    from cusift_tpu_torch.ops.pnp import find_pnp
    from cusift_tpu_torch.optim.lie import se3_exp

    rs = np.random.default_rng(4)
    pts = rs.uniform([-2.0, -1.5, 4.0], [2.0, 1.5, 10.0], size=(512, 3))
    r, t = (a.numpy().astype(np.float64) for a in se3_exp(
        torch.tensor([0.3, 0.05, 0.1, 0.02, 0.06, 0.01], dtype=torch.float64)))
    xa = pts[:, :2] / pts[:, 2:] + rs.normal(scale=5e-4, size=(512, 2))
    pb = pts @ r.T + t
    xb = pb[:, :2] / pb[:, 2:] + rs.normal(scale=5e-4, size=(512, 2))
    xb[rs.choice(512, 150, replace=False)] = rs.uniform(-0.5, 0.5, size=(150, 2))
    res = find_essential(*(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (xa, xb)),
                         torch.ones(512, dtype=torch.bool, device=dev), RansacConfig(),
                         torch.Generator(device=dev).manual_seed(1))
    assert res.r.device.type == "cuda" and bool(res.ok) and int(res.num_inliers) > 300
    np.testing.assert_allclose(res.r.cpu().numpy(), r, atol=1e-2)
    tt = res.t.cpu().numpy()
    assert tt @ t / (np.linalg.norm(tt) * np.linalg.norm(t)) > 0.99

    xy = rs.uniform(-0.5, 0.5, size=(256, 2))
    z = rs.uniform(2.0, 8.0, size=(256, 1))
    pw = (np.concatenate([xy * z, z], -1) - t) @ r
    bad = rs.random(256) < 0.35
    xy[bad] += rs.uniform(0.05, 0.3, size=(bad.sum(), 2)) * rs.choice([-1, 1], size=(bad.sum(), 2))
    p = find_pnp(*(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (pw, xy)),
                 torch.ones(256, dtype=torch.bool, device=dev), RansacConfig(num_hypotheses=256),
                 torch.Generator(device=dev).manual_seed(2))
    assert bool(p.ok) and int(p.num_inliers) >= 0.9 * (~bad).sum()
    assert not np.any(p.inliers.cpu().numpy() & bad)
    np.testing.assert_allclose(p.r.cpu().numpy(), r, atol=5e-3)
    np.testing.assert_allclose(p.t.cpu().numpy(), t, atol=1e-2)


def test_sim3_optimize_card_matches_cpu(dev):
    """The Sim(3) LM on tests/test_sim3.py's drifted loop on the card: the
    final cost within 1e-3 relative of the CPU's (the edge blocks come from
    the card's own matmuls) and 5% of the initial one."""
    from cusift_tpu_torch import PoseGraphConfig
    from cusift_tpu_torch.data.synthetic import pose_ring
    from cusift_tpu_torch.optim.sim3graph import Sim3Graph, optimize

    ring = pose_ring(n=16, drift=0.02, seed=1)
    n, e = ring["init_r"].shape[0], ring["edge_i"].shape[0]
    arrays = dict(poses_r=ring["init_r"], poses_t=ring["init_t"], poses_s=np.ones(n, np.float32),
                  edge_i=ring["edge_i"], edge_j=ring["edge_j"], meas_r=ring["meas_r"],
                  meas_t=ring["meas_t"],
                  meas_s=np.exp(np.random.default_rng(0).normal(0, 0.02, e)).astype(np.float32),
                  weight=ring["weight"])
    cfg = PoseGraphConfig(max_iters=30, cg_iters=60)
    cost = {}
    for d in ("cpu", dev):
        res = optimize(Sim3Graph(**{k: torch.from_numpy(np.array(v)).to(d)
                                    for k, v in arrays.items()}), cfg)
        cost[torch.device(d).type] = (float(res.cost), float(res.initial_cost))
    assert cost["cuda"][0] < 0.05 * cost["cuda"][1]
    np.testing.assert_allclose(cost["cuda"][0], cost["cpu"][0], rtol=1e-3)


def test_mono_vo_on_the_card(dev):
    """A 10-frame MonoVO run with keyframes and window BA on the card
    (tests/test_odometry.py's checkpoint scene): every pair tracked, its
    ring on the card, K1 and K2 launched."""
    from cusift_tpu_torch import VOConfig
    from cusift_tpu_torch.data.synthetic import two_plane_sequence
    from cusift_tpu_torch.models.odometry import MonoVO

    seq = two_plane_sequence(n_frames=10, h=240, w=320, seed=9, motion_scale=0.7, amplitude=2.0)
    vo = MonoVO(seq.intr, sift_cfg=SiftConfig(max_kpts=256, max_kpts_per_octave=192,
                                              num_octaves=3),
                vo_cfg=VOConfig(max_keyframes=16, kf_every=2, loop_temporal_gap=50),
                ba_window=4, device=dev)
    before = (launches("sampler"), launches("matcher"))
    er, et = vo.run(seq.images)
    assert vo._kf_desc.device.type == "cuda" and vo.n_kf >= 4
    assert all(s["ok"] for s in vo.stats) and np.isfinite(et).all() and len(er) == 10
    assert launches("sampler") - before[0] == 10 * 2 * 3 and launches("matcher") > before[1] + 9


SEGMENT_SHAPES = {"ba_cam": (3000, 10, (6, 6)), "ba_pt": (3000, 1200, (3, 3)),
                  "posegraph": (144, 24, (6,)), "sim3": (256, 40, (7,)),
                  "monomap": (2048, 8192, (3,)), "monomap_cnt": (2048, 8192, ()),
                  "f64": (500, 7, (2,)), "empty": (0, 5, (3,)),
                  "long": (4096, 1, (3,)), "long_d36": (4096, 2, (36,)),
                  "f64_long": (4096, 1, (3,)), "f64_d36": (3000, 10, (6, 6)),
                  "wide": (1000, 20, (100,))}


@pytest.mark.parametrize("name", sorted(SEGMENT_SHAPES))
def test_segment_kernel_matches_cpu(dev, name):
    """The segment-sum kernel against the CPU's `index_add_` on the same
    inputs: the same order of adds (tests/test_torch_segment.py replays
    it), so equal bit for bit; and a rerun equal bit for bit.  Among them
    a 4,096-row segment (streamed through the block's chunks), d = 36 in
    float32 and float64, and 100 columns (column tiles)."""
    from cusift_tpu_torch.kernels import segment

    rows, n, tail = SEGMENT_SHAPES[name]
    dtype = np.float64 if name.startswith("f64") else np.float32
    rng = np.random.default_rng(len(name))
    idx = torch.from_numpy(rng.integers(0, n, rows))
    x = torch.from_numpy(rng.normal(size=(rows,) + tail).astype(dtype))
    ref = torch.zeros((n,) + tail, dtype=x.dtype).index_add_(0, idx, x)
    p = segment.plan(idx.to(dev), n)
    before = launches("segment")
    got = segment.segment_sum(x.to(dev), p)
    again = segment.segment_sum(x.to(dev), p)
    torch.cuda.synchronize()
    assert launches("segment") == before + (2 if rows else 0)
    assert torch.equal(got, again)
    assert got.dtype == ref.dtype and torch.equal(got.cpu(), ref)


def test_segment_kernel_drops_rows_outside(dev):
    """Rows whose index lies outside [0, n) are left out on the card: the
    sums of the kept rows, bit for bit, and 0 where no row is kept."""
    from cusift_tpu_torch.kernels import segment

    rng = np.random.default_rng(11)
    n = 60
    idx = torch.from_numpy(rng.integers(-3, n + 3, 3000))
    x = torch.from_numpy(rng.normal(size=(3000, 6)).astype(np.float32))
    keep = (idx >= 0) & (idx < n)
    ref = torch.zeros(n, 6).index_add_(0, idx[keep], x[keep])
    got = segment.segment_sum(x.to(dev), segment.plan(idx.to(dev), n))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


def test_segment_kernel_trailing_empty_segments(dev):
    """The map refinement's layout: 2,048 rows on the first 512 of 8,192
    segments, 402 on one; the trailing segments, which no block owns, are
    0; bit for bit against the CPU at d = 1 and 3."""
    from cusift_tpu_torch.kernels import segment

    rng = np.random.default_rng(12)
    idx = torch.from_numpy(rng.permutation(np.concatenate([np.zeros(402, np.int64),
                                                           rng.integers(1, 512, 1646)])))
    p = segment.plan(idx.to(dev), 8192)
    for tail in ((), (3,)):
        x = torch.from_numpy(rng.normal(size=(2048,) + tail).astype(np.float32))
        ref = torch.zeros((8192,) + tail).index_add_(0, idx, x)
        got = segment.segment_sum(x.to(dev), p)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref)


def _sfm_like_problem(dev):
    from cusift_tpu_torch.optim.ba import BAProblem

    rng = np.random.default_rng(3)
    c, l, o = 6, 400, 2000
    pts = np.stack([rng.uniform(-2, 2, l), rng.uniform(-1, 1, l), rng.uniform(4, 8, l)], -1)
    cam = rng.integers(0, c, o)
    pt = rng.integers(0, l, o)
    t = np.zeros((c, 3), np.float32)
    t[:, 0] = np.linspace(0, 0.5, c)
    pc = pts[pt] + t[cam]
    uv = np.stack([200 * pc[:, 0] / pc[:, 2] + 160, 200 * pc[:, 1] / pc[:, 2] + 120], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    arrays = dict(poses_r=np.tile(np.eye(3, dtype=np.float32), (c, 1, 1)),
                  poses_t=t + rng.normal(0, 0.01, t.shape), points=pts + rng.normal(0, 0.02, pts.shape),
                  intr=np.array([200, 200, 160, 120]), cam_idx=cam, pt_idx=pt, uv=uv,
                  w=np.ones(o))
    return BAProblem(**{k: torch.from_numpy(np.asarray(v, np.int64 if k.endswith("idx")
                                                       else np.float32)).to(dev)
                        for k, v in arrays.items()})


def test_solvers_rerun_bit_identical_on_the_card(dev):
    """BA off the grid (an SfM-like problem), the pose graph's CG and the
    Sim(3) CG give the same bits on a rerun; BA's cost within 1e-4 of the
    CPU's."""
    from cusift_tpu_torch import BAConfig, PoseGraphConfig
    from cusift_tpu_torch.data.synthetic import pose_ring
    from cusift_tpu_torch.kernels import segment
    from cusift_tpu_torch.optim.ba import bundle_adjust
    from cusift_tpu_torch.optim.posegraph import PoseGraph
    from cusift_tpu_torch.optim.posegraph import optimize as pg_optimize
    from cusift_tpu_torch.optim.sim3graph import Sim3Graph
    from cusift_tpu_torch.optim.sim3graph import optimize as sim3_optimize

    before = launches("segment")
    prob = _sfm_like_problem(dev)
    cfg = BAConfig(max_iters=6, cg_iters=30)
    runs = [bundle_adjust(prob, cfg) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    cpu = bundle_adjust(_sfm_like_problem("cpu"), cfg)
    np.testing.assert_allclose(float(runs[0].cost), float(cpu.cost), rtol=1e-4)
    ring = pose_ring(n=24, drift=0.03, seed=2)
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in ring.items()}
    g = PoseGraph(t["init_r"], t["init_t"], t["edge_i"], t["edge_j"], t["meas_r"],
                  t["meas_t"], t["weight"])
    pcfg = PoseGraphConfig(max_iters=10, cg_iters=50, solver="cg")
    for a, b in zip(pg_optimize(g, pcfg), pg_optimize(g, pcfg)):
        assert torch.equal(a, b)
    g3 = Sim3Graph(t["init_r"], t["init_t"], torch.ones(24, device=dev), t["edge_i"],
                   t["edge_j"], t["meas_r"], t["meas_t"],
                   torch.ones(t["edge_i"].shape[0], device=dev), t["weight"])
    scfg = PoseGraphConfig(max_iters=20, cg_iters=60)
    for a, b in zip(sim3_optimize(g3, scfg), sim3_optimize(g3, scfg)):
        assert torch.equal(a, b)
    assert launches("segment") > before


def test_localize_step_refinement_bit_identical_on_the_card(dev):
    """`localize_step` on the card twice with the same generator seed:
    every output, the refined landmark positions included, equal bit for
    bit, and its pose within 1e-4 of the CPU's."""
    from cusift_tpu_torch.config import MatchConfig, RansacConfig
    from cusift_tpu_torch.kernels import segment
    from cusift_tpu_torch.models.monomap import LandmarkMap, localize_step
    from monomap_scene import clean_scene

    s = clean_scene()

    def run(d):
        t = {k: (torch.from_numpy(np.array(v)).to(d) if isinstance(v, np.ndarray) else v)
             for k, v in s.items() if k != "lmap"}
        lmap = LandmarkMap(*(a.to(d) for a in s["lmap"]))
        one = torch.ones((), device=d)
        return localize_step(t["desc"], t["valid"], t["x"], t["y"], t["intr"], t["depth"],
                             t["pts"], one > 0, t["pair_r"], t["pair_t"], one, one, t["prev_r"],
                             t["prev_t"], t["last_r"], t["last_t"], lmap, 5, 1, 20, 3, 8, 0.4,
                             MatchConfig(), RansacConfig(num_hypotheses=64),
                             torch.Generator(device=d).manual_seed(0))

    before = launches("segment")
    a, b = run(dev), run(dev)
    torch.cuda.synchronize()
    assert launches("segment") == before + 4
    for x, y in zip(a[:-1], b[:-1]):
        assert torch.equal(x, y)
    for x, y in zip(a.lmap, b.lmap):
        assert torch.equal(x, y)
    cpu = run("cpu")
    assert float(a.packed[14]) == 1.0
    np.testing.assert_allclose(a.packed.cpu().numpy(), cpu.packed.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(a.lmap.pos.cpu().numpy(), cpu.lmap.pos.numpy(), atol=1e-4)
    assert torch.equal(a.lmap.nobs.cpu(), cpu.lmap.nobs)


def test_mono_vo_map_anchor_on_the_card(dev):
    """tests/test_monomap.py's map-anchored scene on the card: PnP takes
    over, every frame tracked by the pair or the map, ATE under 0.16 of the
    path, the segment kernel launched by the refinement."""
    from cusift_tpu_torch import RansacConfig, VOConfig
    from cusift_tpu_torch.data.evaluation import ate_rmse, trajectory_path_length
    from cusift_tpu_torch.data.synthetic import two_plane_sequence
    from cusift_tpu_torch.kernels import segment
    from cusift_tpu_torch.models.odometry import MonoVO

    seq = two_plane_sequence(n_frames=14, h=240, w=320, seed=3, near=3.0, far=6.0,
                             motion_scale=0.6)
    vo = MonoVO(seq.intr, sift_cfg=SiftConfig(max_kpts=384, max_kpts_per_octave=256,
                                              num_octaves=3, upscale=False),
                ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3),
                vo_cfg=VOConfig(max_keyframes=32, kf_every=2, map_anchor=True, map_size=2048,
                                map_active_kf=8, map_insert_budget=256, map_min_inliers=15,
                                map_min_obs=2, map_min_anchor=8, loop_temporal_gap=1000),
                device=dev)
    before = launches("segment")
    er, et = vo.run(seq.images)
    assert vo._lmap.pos.device.type == "cuda" and launches("segment") - before == 2 * 13
    pnp = [s["pnp_ok"] for s in vo.stats]
    assert sum(pnp[3:]) >= 0.7 * len(pnp[3:])
    assert all(s["ok"] or s["pnp_ok"] for s in vo.stats)
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
    assert ate < 0.16 * trajectory_path_length(seq.poses_r, seq.poses_t)[-1]


# The RANSAC homography kernels (kernels/homography.py) against the plain
# version of ops/ransac.py on the card, on the same [HYP, 4] samples of
# chip_smoke.py's scene (phase 36): graf-batch8's shape, MonoVO's
# keyframe-candidate homography (normalised coordinates at twice
# inlier_thresh_epi) and a ragged one (N and HYP not multiples of the
# blocks').
HOM_SHAPES = {"graf": ("pixels", 6144, 1024, 3.0), "mono_vo": ("normalised", 2048, 1024, 0.004),
              "ragged": ("pixels", 1001, 77, 3.0)}
# a float32 minimal solve within C_MINIMAL x 2^-23 x cond(A^T A) of the
# float64 DLT, relative to max |H| (tests/test_torch_twoview.py)
C_MINIMAL = 128.0


def hom_scene(kind, n, nhyp, seed):
    """chip_smoke.py's scene for phase 36: a plane seen twice (40% outliers,
    10% invalid rows) and nhyp samples of 4 valid rows."""
    from chip_smoke import hom_scene

    return hom_scene(kind, n, nhyp, seed)


def _dlt64(pa, pb):
    """The float64 minimal homography with the packages' normalisation and
    its normal matrix's condition."""
    def norm(x):
        c = x.mean(0)
        s = np.sqrt(2) / np.linalg.norm(x - c, axis=1).mean()
        return (x - c) * s, np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])

    (an, ta), (bn, tb) = norm(pa.astype(np.float64)), norm(pb.astype(np.float64))
    rows = [[xa, ya, 1, 0, 0, 0, -xb * xa, -xb * ya] for (xa, ya), (xb, _) in zip(an, bn)]
    rows += [[0, 0, 0, xa, ya, 1, -yb * xa, -yb * ya] for (xa, ya), (_, yb) in zip(an, bn)]
    a, b = np.array(rows), np.concatenate([bn[:, 0], bn[:, 1]])
    h = np.linalg.inv(tb) @ np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3) @ ta
    return h / h[2, 2], np.linalg.cond(a.T @ a)


def _same_bits(a, b):
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("name", sorted(HOM_SHAPES))
def test_homography_kernels_match_plain(dev, name):
    """Weights equal; each hypothesis within the float64 DLT bound; counts
    equal on >= 99.9% of hypotheses; the same winner; after 5 IRLS rounds h
    within 1e-4 of the plain version's (relative to max |H|), the same
    inliers, count and ok."""
    from cusift_tpu_torch.kernels import homography as kh
    from cusift_tpu_torch.ops import ransac

    kind, n, nhyp, thresh = HOM_SHAPES[name]
    pa, pb, valid, idx = hom_scene(kind, n, nhyp, len(name))
    ta, tb, tv, ti = (torch.from_numpy(x).to(dev) for x in (pa, pb, valid, idx))
    before = launches("homography")
    p = kh.weights(tv)
    hs, counts = kh.score(ta, tb, tv, ti, thresh)
    first = kh.refine(ta, tb, tv, thresh, 0, 8, hs=hs, counts=counts)[0]
    h, inl, num, ok = kh.refine(ta, tb, tv, thresh, 5, 8, hs=hs, counts=counts)
    torch.cuda.synchronize()
    assert launches("homography") == before + 4
    assert torch.equal(p, tv.float())
    for i in range(0, nhyp, max(1, nhyp // 64)):
        if len(set(idx[i].tolist())) == 4:
            truth, cond = _dlt64(pa[idx[i]], pb[idx[i]])
            err = np.abs(hs[i].double().cpu().numpy() - truth).max()
            assert err <= C_MINIMAL * 2.0 ** -23 * cond * np.abs(truth).max(), i
    phs = ransac._hypotheses(ta, tb, ti)
    pcounts = ransac._scores(phs, ta, tb, tv, thresh)
    assert float((counts.long() == pcounts).float().mean()) >= 0.999
    best = int(torch.argmax(pcounts))
    assert int(torch.argmax(counts)) == best and _same_bits(first, hs[best])
    ref = ransac._refine(phs[best], ta, tb, tv, thresh, 5, 8)
    _close_rel(h, ref.h, 1e-4)
    assert torch.equal(inl, ref.inliers) and int(num) == int(ref.num_inliers)
    assert bool(ok) == bool(ref.ok) and bool(ok)


def test_homography_kernels_degenerate_inputs(dev):
    """No valid row: uniform weights, ok false.  Fewer than 4 valid rows:
    the winner kept through IRLS, ok false.  Repeated rows in a sample: a
    count of -1 exactly where the hypothesis is not finite, in the kernel
    and the plain version alike.  A NaN row: every hypothesis that samples
    it counts -1, as the plain version's.  Ties in the counts: the first
    index, as torch.argmax, and index 0 when all are -1."""
    from cusift_tpu_torch.kernels import homography as kh
    from cusift_tpu_torch.ops import ransac

    pa, pb, valid, idx = hom_scene("pixels", 300, 40, 5)
    idx[7] = idx[7, 0]                     # one row four times
    idx[8, 2] = idx[8, 1]                  # a repeated row
    ta, tb, tv, ti = (torch.from_numpy(x).to(dev) for x in (pa, pb, valid, idx))
    none = torch.zeros(300, dtype=torch.bool, device=dev)
    assert torch.equal(kh.weights(none), torch.ones(300, device=dev))
    hs, counts = kh.score(ta, tb, none, ti, 3.0)
    finite = torch.isfinite(hs.reshape(40, 9)).all(-1)
    assert torch.equal(counts, torch.where(finite, 0, -1).int())
    h, inl, num, ok = kh.refine(ta, tb, none, 3.0, 5, 8, hs=hs, counts=counts)
    assert _same_bits(h, hs[int(torch.argmax(counts))])
    assert not inl.any() and int(num) == 0 and not bool(ok)
    three = none.clone()
    three[ti[0, :3]] = True
    hs, counts = kh.score(ta, tb, three, ti, 3.0)
    h, inl, num, ok = kh.refine(ta, tb, three, 3.0, 5, 4, hs=hs, counts=counts)
    assert _same_bits(h, hs[int(torch.argmax(counts))]) and int(num) <= 3 and not bool(ok)
    # repeated rows: a count of -1 exactly where the hypothesis is not finite
    hs, counts = kh.score(ta, tb, tv, ti, 3.0)
    phs = ransac._hypotheses(ta, tb, ti)
    for got, n_got in ((hs, counts), (phs, ransac._scores(phs, ta, tb, tv, 3.0))):
        assert torch.equal(n_got == -1, ~torch.isfinite(got.reshape(40, 9)).all(-1))
    nan_pa = ta.clone()
    nan_pa[ti[3, 1]] = float("nan")
    hs, counts = kh.score(nan_pa, tb, tv, ti, 3.0)
    phs = ransac._hypotheses(nan_pa, tb, ti)
    hit = (ti == ti[3, 1]).any(1)
    assert bool((counts[hit] == -1).all()) and not torch.isfinite(phs[hit]).any()
    assert torch.equal(counts[~hit] == -1, ~torch.isfinite(hs[~hit].reshape(-1, 9)).all(-1))
    tied = torch.tensor([3, 7, 2, 7, 7, 1], dtype=torch.int32, device=dev)
    six = torch.arange(54, dtype=torch.float32, device=dev).reshape(6, 3, 3)
    got = kh.refine(ta, tb, tv, 3.0, 0, hs=six, counts=tied)[0]
    assert torch.equal(got, six[1])
    got = kh.refine(ta, tb, tv, 3.0, 0, hs=six, counts=torch.full_like(tied, -1))[0]
    assert torch.equal(got, six[0])


def test_homography_kernels_rerun_bit_identical(dev):
    """Two runs of the three kernels at graf's shape give the same bytes."""
    from cusift_tpu_torch.kernels import homography as kh

    pa, pb, valid, idx = (torch.from_numpy(x).to(dev)
                          for x in hom_scene("pixels", 6144, 1024, 9))
    runs = []
    for _ in range(2):
        hs, counts = kh.score(pa, pb, valid, idx, 3.0)
        runs.append((kh.weights(valid), hs, counts,
                     *kh.refine(pa, pb, valid, 3.0, 5, 8, hs=hs, counts=counts)))
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(*runs))


def test_find_homography_on_the_card(dev):
    """find_homography on CUDA tensors: the plain version's draws (the same
    generator state gives the plain version's samples), three kernels and
    at most 12 device operations, sampling included; the result as the
    plain version's from those samples.  improve_homography: one kernel,
    within 1e-4 of the plain IRLS."""
    from torch.profiler import ProfilerActivity, profile

    from cusift_tpu_torch import RansacConfig
    from cusift_tpu_torch.ops import ransac

    pa, pb, valid, _ = (torch.from_numpy(x).to(dev) for x in hom_scene("pixels", 6144, 8, 13))
    cfg = RansacConfig()
    ransac.find_homography(pa, pb, valid, cfg, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    before = launches("homography")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = ransac.find_homography(pa, pb, valid, cfg, torch.Generator(device=dev).manual_seed(2))
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != "ransac.homography"]
    assert launches("homography") == before + 3 and len(ops) <= 12, [e.name for e in ops]
    idx = ransac._sample_indices(torch.Generator(device=dev).manual_seed(2), valid,
                                 cfg.num_hypotheses, 4)
    hs = ransac._hypotheses(pa, pb, idx)
    best = torch.argmax(ransac._scores(hs, pa, pb, valid, cfg.inlier_thresh))
    ref = ransac._refine(hs[best], pa, pb, valid, cfg.inlier_thresh, cfg.refine_iters,
                         cfg.min_matches)
    _close_rel(res.h, ref.h, 1e-4)
    assert int(res.num_inliers) == int(ref.num_inliers) and bool(res.ok)
    assert res.inliers.dtype == torch.bool and res.num_inliers.dtype == torch.int64
    start = res.h.clone()
    start[0, 2] += 2.0
    before = launches("homography")
    got = ransac.improve_homography(start, pa, pb, valid)
    assert launches("homography") == before + 1
    _close_rel(got, ransac._irls(start, pa, pb, valid, 3.0, 5), 1e-4)

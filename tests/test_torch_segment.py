"""Deterministic segment sums (cusift_tpu_torch/kernels/segment.py).

* On the CPU `segment_sum` is `index_add_`, so every CPU result keeps its
  bits; and the card kernel's walk (the rows sorted stably by segment,
  each segment summed from 0 in ascending row order) replayed in numpy
  float32 equals `index_add_` bit for bit at the shapes of each user: the
  SfM bundle adjustment's camera and landmark sums and its dense solver's
  (landmark, camera) key, the SE(3) pose graph's and the Sim(3) graph's
  CG scatters, and the landmark map's refinement (2048 rows into 8192).
* The card's plan cuts the sorted rows into blocks (`segment.partition`,
  the same torch code on the CPU): every sorted row inside [0, n) and
  every segment before the trailing ones (no row at or after their
  start) belongs to exactly one block, the trailing ones to none.  The
  redesigned kernel's walk (each block zeroes its share of the trailing
  segments and all its own, stages its rows chunk by chunk, a piece per
  segment and chunk adds from 0 or from the sum the last chunk handed
  on) replayed in numpy at the wrapper's launch shape equals `index_add_`
  bit for bit, zeroes every output once and writes each non-empty
  segment's sum once: empty segments, the map's 2,048 rows on the first
  512 of 8,192 segments, a 4,096-row segment, a segment starting on a
  tile's last row, indices outside [0, n), float64, d = 1, 3, 36 and 100
  (column tiles), R = 0.
* Each solver makes its plans once a problem, not once a CG round.
* A plan made on the CPU carries no walk; a tensor on a device with no
  kernel raises.
"""

import numpy as np
import pytest
import torch

from cusift_tpu_torch import BAConfig, PoseGraphConfig
from cusift_tpu_torch.kernels import segment

torch.set_num_threads(2)

# (rows, segments, trailing shape) of each user
SHAPES = {"ba_cam": (3000, 10, (6, 6)), "ba_pt": (3000, 1200, (3, 3)),
          "ba_rhs": (3000, 10, (6,)), "ba_dense_key": (3000, 12000, (6, 3)),
          "posegraph": (2 * 72, 24, (6,)), "sim3": (2 * 128, 40, (7,)),
          "monomap_cnt": (2048, 8192, ()), "monomap_sum": (2048, 8192, (3,))}


def _replay(x: np.ndarray, order: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic in numpy float32: per segment, from 0, one
    add a row in `order`."""
    n = offsets.shape[0] - 1
    flat = x.reshape(x.shape[0], -1)
    acc = np.zeros((n, flat.shape[1]), np.float32)
    lens = np.diff(offsets)
    for k in range(int(lens.max(initial=0))):
        live = lens > k
        acc[live] = acc[live] + flat[order[offsets[:-1][live] + k]]
    return acc.reshape((n,) + x.shape[1:])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_walk_replay_equals_index_add(name):
    rows, n, tail = SHAPES[name]
    rng = np.random.default_rng(len(name))
    idx = rng.integers(0, n, rows)
    x = (rng.normal(size=(rows,) + tail) * rng.uniform(1e-3, 1e3, (rows,) + (1,) * len(tail))
         ).astype(np.float32)
    p = segment.plan(torch.from_numpy(idx), n)
    assert p.order is None and p.offsets is None
    got = segment.segment_sum(torch.from_numpy(x), p).numpy()
    ref = torch.zeros((n,) + tail).index_add_(0, torch.from_numpy(idx), torch.from_numpy(x))
    np.testing.assert_array_equal(got, ref.numpy())
    order, offsets = segment.walk(torch.from_numpy(idx), n)
    np.testing.assert_array_equal(np.diff(offsets.numpy()), np.bincount(idx, minlength=n))
    for s in range(0, n, max(1, n // 7)):                      # ascending rows in a segment
        seg = order.numpy()[offsets[s]:offsets[s + 1]]
        assert np.all(np.diff(seg) > 0) and np.all(idx[seg] == s)
    np.testing.assert_array_equal(_replay(x, order.numpy(), offsets.numpy()), ref.numpy())


def _case(name: str):
    """(idx, n, x) of a case of the redesigned kernel's walk."""
    rng = np.random.default_rng(sum(map(ord, name)))
    tail, dtype = (3,), np.float32
    if name == "empty segments":                 # most of 1,000 segments empty
        n, idx = 1000, rng.integers(0, 1000, 300)
    elif name == "long segment":                 # 4,096 rows on one segment, 16 tiles
        n = 7
        rest = rng.integers(0, n - 1, 500)
        idx = rng.permutation(np.concatenate([np.full(4096, 3), rest + (rest >= 3)]))
    elif name == "tile's last row":              # segment 1 starts at sorted row TILE - 1
        n = 40
        idx = rng.permutation(np.concatenate([np.zeros(segment.TILE - 1, np.int64),
                                              np.full(300, 1), rng.integers(2, n, 700)]))
    elif name == "trailing empty segments":      # the map's: live rows on its first slots
        n = 8192
        idx = rng.permutation(np.concatenate([np.zeros(402, np.int64), rng.integers(1, 512, 1646)]))
    elif name == "outside [0, n)":
        n = 50
        idx = rng.integers(-3, n + 3, 1500)
    elif name == "float64":
        n, idx, tail, dtype = 12, rng.integers(0, 12, 2000), (6, 6), np.float64
    elif name.startswith("d = "):
        width = int(name[4:])
        n, idx, tail = 30, rng.integers(0, 30, 2000), (width,) if width > 1 else ()
    else:                                        # "R = 0"
        n, idx = 6, np.zeros(0, np.int64)
    scale = rng.uniform(1e-3, 1e3, (len(idx),) + (1,) * len(tail))
    x = (rng.normal(size=(len(idx),) + tail) * scale).astype(dtype)
    return idx.astype(np.int64), n, x


CASES = ["empty segments", "trailing empty segments", "long segment", "tile's last row",
         "outside [0, n)", "float64",
         "d = 1", "d = 3", "d = 36", "d = 100", "R = 0"]


def _card_plan(idx: np.ndarray, n: int) -> dict:
    """The card's plan made by the same torch code on the CPU, as numpy."""
    t = torch.from_numpy(idx)
    order, offsets = segment.walk(t, n)
    seg, ends, blocks = segment.partition(t, n, order, offsets)
    return dict(order=order.numpy(), offsets=offsets.numpy(), seg=seg.numpy(),
                ends=ends.numpy(), blocks=blocks.numpy())


def _kernel_replay(x: np.ndarray, plan: dict, n: int) -> tuple[np.ndarray, ...]:
    """csrc/segment.cu's walk in numpy at the wrapper's launch shape: for
    each block and column tile, 0 to its share of the trailing segments
    (no row at or after their start) and to all its segments; its sorted rows
    staged chunk by chunk from its tile's start (the gather x[order] into
    a slab, from the block's first row); in each chunk a piece per segment
    adds its rows in ascending order, from 0 or from the sum the last chunk
    handed on, and writes its sum where its segment ends.  Returns (out,
    zero stores and sum stores of each output element)."""
    d = int(np.prod(x.shape[1:]))
    flat = x.reshape(x.shape[0], d)
    shape = segment.launch_shape(d, x.itemsize)
    chunk, d_tile = shape["chunk"], shape["d_tile"]
    order, seg, ends, blocks = (plan[k] for k in ("order", "seg", "ends", "blocks"))
    out = np.full((n, d), np.nan, x.dtype)
    zeros = np.zeros((n, d), np.int64)
    writes = np.zeros((n, d), np.int64)
    nb = blocks.shape[0] - 1
    tail = blocks[nb, 0]
    share = -(-(n - tail) // nb) if nb else 0
    for b in range(nb):
        (s_lo, a), (s_hi, e) = blocks[b], blocks[b + 1]
        t0 = b * segment.TILE
        for c0 in range(0, d, d_tile):
            cols = slice(c0, min(d, c0 + d_tile))
            z_lo = tail + b * share                      # its share of the trailing segments
            out[z_lo:min(z_lo + share, n), cols] = 0
            zeros[z_lo:min(z_lo + share, n), cols] += 1
            if s_lo == s_hi:
                continue
            out[s_lo:s_hi, cols] = 0
            zeros[s_lo:s_hi, cols] += 1
            carry, carried = None, -1
            for k0 in range(t0, e, chunk):
                lo, rows = max(a - k0, 0), min(chunk, e - k0)
                slab = np.zeros((rows, cols.stop - c0), x.dtype)
                slab[lo:] = flat[order[k0 + lo:k0 + rows], cols]
                handed, handed_seg = None, -1
                for j in range(lo, rows):
                    s = seg[k0 + j]
                    if j > lo and seg[k0 + j - 1] == s:
                        continue
                    end = ends[k0 + j] - k0
                    acc = carry if j == 0 and s == carried else np.zeros_like(slab[0])
                    for r in range(j, min(end, rows)):
                        acc = acc + slab[r]
                    if end <= rows:
                        out[s, cols] = acc
                        writes[s, cols] += 1
                    else:
                        handed, handed_seg = acc, s
                carry, carried = handed, handed_seg
    return out.reshape((n,) + x.shape[1:]), zeros, writes


def _index_add(idx: np.ndarray, n: int, x: np.ndarray) -> np.ndarray:
    keep = (idx >= 0) & (idx < n)
    ref = torch.zeros((n,) + x.shape[1:], dtype=torch.from_numpy(x).dtype)
    return ref.index_add_(0, torch.from_numpy(idx[keep]), torch.from_numpy(x[keep])).numpy()


@pytest.mark.parametrize("name", CASES + [f"shape {k}" for k in sorted(SHAPES)])
def test_partition_owns_every_row_and_segment_once(name):
    if name.startswith("shape "):
        rows, n, _ = SHAPES[name[6:]]
        idx = np.random.default_rng(len(name)).integers(0, n, rows)
    else:
        idx, n, _ = _case(name)
    p = _card_plan(idx, n)
    blocks, offsets = p["blocks"], p["offsets"]
    nb = -(-len(idx) // segment.TILE)
    assert blocks.shape == (nb + 1, 2) and blocks.dtype == np.int32
    first, row = blocks[:, 0].astype(np.int64), blocks[:, 1].astype(np.int64)
    assert np.all(np.diff(first) >= 0) and np.all(row == offsets[first])
    tail = int(np.searchsorted(offsets, offsets[n]))     # no row at or after its start
    assert np.all(offsets[tail:] == offsets[n]) and (tail == 0 or offsets[tail - 1] < offsets[n])
    if nb:
        assert first[0] == 0 and first[-1] == tail
    owner_seg = np.full(n, -1)
    owner_row = np.full(len(idx), -1)
    for b in range(nb):
        assert np.all(owner_seg[first[b]:first[b + 1]] == -1)
        owner_seg[first[b]:first[b + 1]] = b
        assert np.all(owner_row[row[b]:row[b + 1]] == -1)
        owner_row[row[b]:row[b + 1]] = b
    inside = (idx >= 0) & (idx < n)
    if nb:
        # a segment's block is the tile of its first sorted row; the
        # trailing segments belong to none
        np.testing.assert_array_equal(owner_seg[:tail], offsets[:tail] // segment.TILE)
        assert np.all(owner_seg[tail:] == -1)
    np.testing.assert_array_equal(np.sort(p["order"][owner_row >= 0]), np.flatnonzero(inside))
    live = np.flatnonzero(owner_row >= 0)
    np.testing.assert_array_equal(p["seg"][live], idx[p["order"][live]])
    np.testing.assert_array_equal(p["ends"][live], offsets[idx[p["order"][live]] + 1])


@pytest.mark.parametrize("name", CASES)
def test_kernel_walk_replay_equals_index_add(name):
    idx, n, x = _case(name)
    out, zeros, writes = _kernel_replay(x, _card_plan(idx, n), n)
    ref = _index_add(idx, n, x)
    if len(idx):       # one block zeroes each output; a non-empty segment's sum lands once
        assert np.all(zeros == 1)
        keep = (idx >= 0) & (idx < n)
        live = np.bincount(idx[keep], minlength=n) > 0
        np.testing.assert_array_equal(writes, np.where(live[:, None], 1, 0) * np.ones_like(writes))
    assert out.dtype == ref.dtype
    if len(idx):
        np.testing.assert_array_equal(out, ref)
    if name == "long segment":
        assert np.bincount(idx, minlength=n).max() == 4096
        assert segment.launch_shape(3, 4)["chunk"] < 4096     # it streams
    if name == "tile's last row":
        p = _card_plan(idx, n)
        assert p["offsets"][1] == segment.TILE - 1


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", [1, 3, 6, 7, 9, 18, 36, 49, 100, 1000])
def test_launch_shape_fits_the_block(d, itemsize):
    s = segment.launch_shape(d, itemsize)
    assert 1 <= s["d_tile"] <= segment.MAX_COLS
    assert 8 <= s["chunk"] <= segment.MAX_CHUNK and s["chunk"] % 8 == 0
    assert s["smem"] <= segment.SMEM_BUDGET <= 227 * 1024
    tiles = -(-d // s["d_tile"])
    assert (tiles - 1) * s["d_tile"] < d <= tiles * s["d_tile"] and tiles <= 65535
    # csrc/segment.cu's layout: two [d_tile][chunk + 16 bytes] slabs, two
    # carries, three index stages (8 + 4 + 4 bytes a row), two carried
    # segments, the piece list and 32 warp counts
    pitch = s["chunk"] + 16 // itemsize
    assert s["smem"] == (2 * s["d_tile"] * (pitch + 1) * itemsize + 3 * s["chunk"] * 16
                         + (2 + s["chunk"] + 32) * 4)


def test_walk_leaves_out_rows_outside_the_segments():
    idx = torch.tensor([3, -1, 0, 5, 3, 9, 0])
    order, offsets = segment.walk(idx, 5)
    assert offsets.tolist() == [1, 3, 3, 3, 5, 5]
    assert order[1:5].tolist() == [2, 6, 0, 4]


def test_wrapper_raises_on_a_device_without_kernel():
    x = torch.zeros(4, 3, device="meta")
    p = segment.Plan(torch.zeros(4, dtype=torch.long, device="meta"), 2, None, None)
    with pytest.raises(ValueError, match="no kernel"):
        segment.segment_sum(x, p)


def test_solvers_make_their_plans_once(monkeypatch):
    """BA (an SfM-like problem off the grid), the SE(3) CG and the Sim(3)
    CG make their plans once a solve, whatever their LM and CG rounds."""
    from cusift_tpu_torch.data.synthetic import pose_ring
    from cusift_tpu_torch.optim.ba import BAProblem, bundle_adjust
    from cusift_tpu_torch.optim.posegraph import PoseGraph
    from cusift_tpu_torch.optim.posegraph import optimize as pg_optimize
    from cusift_tpu_torch.optim.sim3graph import Sim3Graph
    from cusift_tpu_torch.optim.sim3graph import optimize as sim3_optimize

    made, real = [], segment.plan
    monkeypatch.setattr(segment, "plan", lambda idx, n: made.append(n) or real(idx, n))
    rng = np.random.default_rng(0)
    c, l, o = 4, 30, 90
    prob = BAProblem(poses_r=torch.eye(3).repeat(c, 1, 1), poses_t=torch.zeros(c, 3),
                     points=torch.from_numpy(rng.uniform(-1, 1, (l, 3)).astype(np.float32)
                                             + np.float32([0, 0, 5])),
                     intr=torch.tensor([200.0, 200.0, 160.0, 120.0]),
                     cam_idx=torch.from_numpy(rng.integers(0, c, o)),
                     pt_idx=torch.from_numpy(rng.integers(0, l, o)),
                     uv=torch.from_numpy(rng.uniform(100, 200, (o, 2)).astype(np.float32)),
                     w=torch.ones(o))
    res = bundle_adjust(prob, BAConfig(max_iters=3, cg_iters=10))
    assert made == [c, l] and torch.isfinite(res.cost)

    ring = pose_ring(n=12, drift=0.02, seed=1)
    t = {k: torch.from_numpy(np.array(v)) for k, v in ring.items()}
    del made[:]
    g = PoseGraph(t["init_r"], t["init_t"], t["edge_i"], t["edge_j"], t["meas_r"],
                  t["meas_t"], t["weight"])
    pg_optimize(g, PoseGraphConfig(max_iters=3, cg_iters=20, solver="cg"))
    assert made == [12]
    del made[:]
    pg_optimize(g, PoseGraphConfig(max_iters=3, solver="dense"))
    assert made == []
    sim3_optimize(Sim3Graph(t["init_r"], t["init_t"], torch.ones(12), t["edge_i"],
                            t["edge_j"], t["meas_r"], t["meas_t"],
                            torch.ones(t["edge_i"].shape[0]), t["weight"]),
                  PoseGraphConfig(max_iters=3, cg_iters=20))
    assert made == [12]

"""Deterministic segment sums (cusift_tpu_torch/kernels/segment.py).

* On the CPU `segment_sum` is `index_add_`, so every CPU result keeps its
  bits; and the card kernel's walk (the rows sorted stably by segment,
  each segment summed from 0 in ascending row order) replayed in numpy
  float32 equals `index_add_` bit for bit at the shapes of each user: the
  SfM bundle adjustment's camera and landmark sums and its dense solver's
  (landmark, camera) key, the SE(3) pose graph's and the Sim(3) graph's
  CG scatters, and the landmark map's refinement (2048 rows into 8192).
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

"""The port's landmark-sharded Schur BA (cusift_tpu_torch/parallel/
dist_ba.py) on 2 and 4 gloo ranks, against its single-device solvers and
the JAX package's distributed ones.

* `partition_by_landmark` equals the reference's array for array (on the
  reference generator's problem; the port's `ba_problem` differs from it
  in the last bits of its float32 poses).
* `distributed_bundle_adjust` on `ba_problem(seed=3, n_cams=6, n_pts=64)`
  against the port's `bundle_adjust` and the JAX package's
  `distributed_bundle_adjust` on `map_mesh(n)`, at tests/test_parallel.py's
  tolerances (initial cost rtol 1e-4; poses rtol 1e-3 / atol 1e-4; the
  gathered points rtol 1e-3 / atol 1e-3); every rank returns the same.
* `window_ba_dist` against `window_ba` at test_parallel.py:152's
  tolerances (costs rtol 1e-4, poses atol 5e-4).
* With `group=None` the solver is untouched: `lm_loop` on a one-rank group
  is bit-equal to `lm_loop(group=None)`, and so is `window_ba_dist` on a
  1 x 1 mesh to `window_ba`.

The ranks are spawned processes (`parallel/launch.py`) that rendezvous
through a file and give up after 60 s.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cusift_tpu.config import BAConfig as JBAConfig
from cusift_tpu.data.synthetic import ba_problem as jba_problem
from cusift_tpu.parallel.dist_ba import distributed_bundle_adjust as jdist_ba
from cusift_tpu.parallel.dist_ba import partition_by_landmark as jpartition
from cusift_tpu.parallel.mesh import map_mesh as jmap_mesh
from cusift_tpu_torch import BAConfig, MatchConfig, SiftConfig
from cusift_tpu_torch.data.synthetic import ba_problem, planar_rgbd_sequence, se3_exp
from cusift_tpu_torch.models.local_ba import window_ba
from cusift_tpu_torch.models.slam import _extract_with_points
from cusift_tpu_torch.optim.ba import BAProblem, bundle_adjust, lm_loop
from cusift_tpu_torch.parallel import launch
from cusift_tpu_torch.parallel.dist_ba import (gather_points, partition_by_landmark,
                                               window_ba_dist)
from cusift_tpu_torch.parallel.mesh import ensure_group, map_mesh

torch.set_num_threads(2)

CFG = BAConfig(max_iters=8, cg_iters=30, num_fixed_poses=2)
WIN_CFG = BAConfig(max_iters=5, cg_iters=15, num_fixed_poses=2, huber_delta=4.0)
SIFT = SiftConfig(max_kpts=256, max_kpts_per_octave=128, num_octaves=3)


def _problem():
    prob, _ = ba_problem(seed=3, n_cams=6, n_pts=64, pixel_noise=0.25)
    return prob


def _tensors(prob):
    return BAProblem(**{k: torch.from_numpy(np.asarray(v)) for k, v in prob.items()})


@pytest.fixture(scope="module")
def window_args():
    """test_parallel.py:152's window: five 240x320 keyframes, the three
    newest poses perturbed."""
    seq = planar_rgbd_sequence(5, 240, 320, seed=5, motion_scale=0.8, detail=0.3)
    intr = torch.from_numpy(seq.intr)
    out = [_extract_with_points(torch.from_numpy(seq.images[i]),
                                torch.from_numpy(seq.depths[i]), intr, SIFT) for i in range(5)]
    rs = np.random.default_rng(1)
    pr, pt = seq.poses_r.copy(), seq.poses_t.copy()
    for k in (2, 3, 4):
        dr, dt = se3_exp(rs.normal(scale=0.02, size=6))
        pr[k] = dr @ seq.poses_r[k]
        pt[k] = dr @ seq.poses_t[k] + dt
    return [torch.stack([o[0].desc for o in out]).numpy(),
            torch.stack([o[0].valid for o in out]).numpy(),
            torch.stack([o[1] for o in out]).numpy(),
            pr.astype(np.float32), pt.astype(np.float32), seq.intr, np.ones(5, np.float32)]


@pytest.fixture(scope="module")
def runs(window_args):
    """The 2- and 4-rank cases, on one spawn of 4 ranks."""
    parts = {n: partition_by_landmark(_problem(), n) for n in (2, 4)}
    jobs = {n: dict(parts=parts[n], cfg=CFG, window_args=window_args, window_cfg=WIN_CFG)
            for n in parts}
    out = launch.per_size(launch.run(launch.ba_task, 4, args=(jobs,), device="cpu",
                                     timeout_s=60))
    return {n: (n, parts[n], out[n]) for n in parts}


@pytest.fixture(params=[2, 4])
def ranks(request, runs):
    return runs[request.param]


@pytest.fixture()
def one_rank_group():
    ensure_group("cpu", timeout_s=60)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_partition_by_landmark_equals_reference(n):
    """Both partitions of one problem (the reference's generator's)."""
    jprob, _ = jba_problem(seed=3, n_cams=6, n_pts=64, pixel_noise=0.25)
    jprob = {k: np.asarray(v) for k, v in jprob.items()}
    ours, ref = partition_by_landmark(jprob, n), jpartition(jprob, n)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]))
        assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype, k


def test_distributed_ba_matches_single(ranks):
    n, parts, out = ranks
    single = bundle_adjust(_tensors(_problem()), CFG)
    dist_res = out[0]["ba"]
    for other in out[1:]:
        for a, b in zip(dist_res, other["ba"]):
            assert torch.equal(a, b)
    np.testing.assert_allclose(float(dist_res.initial_cost), float(single.initial_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(dist_res.poses_t.numpy(), single.poses_t.numpy(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(dist_res.poses_r.numpy(), single.poses_r.numpy(),
                               rtol=1e-3, atol=1e-4)
    assert dist_res.points.shape == (n, parts["points"].shape[1], 3)
    np.testing.assert_allclose(gather_points(parts, dist_res.points), single.points.numpy(),
                               rtol=1e-3, atol=1e-3)
    assert float(dist_res.cost) < float(dist_res.initial_cost)


def test_distributed_ba_matches_reference(ranks):
    n, parts, out = ranks
    jprob, _ = jba_problem(seed=3, n_cams=6, n_pts=64, pixel_noise=0.25)
    jparts = jpartition(jprob, n)
    ref = jdist_ba(jparts, jmap_mesh(n), JBAConfig(**dataclasses.asdict(CFG)))
    got = out[0]["ba"]
    np.testing.assert_allclose(float(got.initial_cost), float(ref.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(got.poses_t.numpy(), np.asarray(ref.poses_t),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.poses_r.numpy(), np.asarray(ref.poses_r),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(gather_points(parts, got.points),
                               np.asarray(gather_points(jparts, ref.points)),
                               rtol=1e-3, atol=1e-3)


def test_window_ba_dist_matches_window_ba(ranks, window_args):
    n, _, out = ranks
    t = [torch.from_numpy(np.asarray(a)) for a in window_args]
    r0, t0, c00, c01 = window_ba(*t, MatchConfig(), WIN_CFG)
    assert float(c01) < float(c00)
    for rank in out:
        r1, t1, c10, c11 = rank["window"]
        np.testing.assert_allclose(float(c10), float(c00), rtol=1e-4)
        np.testing.assert_allclose(t1.numpy(), t0.numpy(), atol=5e-4)
        np.testing.assert_allclose(r1.numpy(), r0.numpy(), atol=5e-4)
    assert all(torch.equal(out[0]["window"][1], o["window"][1]) for o in out[1:])


def test_lm_loop_group_none_bit_equal(one_rank_group, window_args):
    """A one-rank group reduces nothing: the distributed code path gives
    the single-device bits, for the solver and for the window BA."""
    p = _tensors(_problem())
    for cfg in (CFG, dataclasses.replace(CFG, huber_delta=2.0)):
        a = lm_loop(p, cfg)
        b = lm_loop(p, cfg, group=dist.group.WORLD)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    t = [torch.from_numpy(np.asarray(a)) for a in window_args]
    for x, y in zip(window_ba(*t, MatchConfig(), WIN_CFG),
                    window_ba_dist(*t, map_mesh(), MatchConfig(), WIN_CFG)):
        assert torch.equal(x, y)
